r"""CVNet — the one model covering the five types (vae / cvae / jvae / xvae / vib).

Port of ``joint_vae_tpu/models/cvnet.py`` (ref
``ClassificationVariationalNetwork``, cvae.py:60-424):

- :class:`CVNetConfig` — static configuration with the per-type tables
  (loss components, predict/OOD/misclass methods, metrics) and the
  architecture dict of params.json;
- :class:`CVNet` — an ``nn.Module`` with ``features`` / ``encode`` /
  ``decode`` / ``classify``; the loss math is ``models/evaluate.py``.

X -- features --- encoder -- Z -- decoder -- imager -- X^
              /                \
           Y_/                  \-- classifier -- Y^
"""

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.priors import PriorConfig, build_prior_config, init_prior_arrays
from ..ops.sigma import SigmaConfig
from .conv import (ACTIVATIONS, BatchNorm, ConvLayer, ConvStack,
                   conv_stack_plan, find_input_shape)
from .layers import Classifier, Dense, Encoder, MLP, PriorParams
from .resnet import TrunkConv, build_trunk

VERSION = '1.0'
DEFAULT_ACTIVATION = 'relu'
DEFAULT_OUTPUT_ACTIVATION = 'sigmoid'
DEFAULT_LATENT_SAMPLING = 100

LOSS_COMPONENTS_PER_TYPE = {
    'jvae': ('cross_x', 'kl', 'cross_y', 'total'),
    'cvae': ('cross_x', 'kl', 'total', 'zdist', 'var_kl', 'dzdist', 'iws',
             'sigma', 'wmse', 'z_logdet', 'z_tr_inv_cov'),
    'xvae': ('cross_x', 'kl', 'total', 'zdist', 'iws'),
    'vae': ('cross_x', 'kl', 'zdist', 'var_kl', 'total', 'iws'),
    'vib': ('cross_y', 'kl', 'total'),
}

PREDICT_METHODS_PER_TYPE = {
    'jvae': ['loss', 'esty'],
    'cvae': ['iws', 'closest'],
    'xvae': ['loss', 'closest'],
    'vae': [],
    'vib': ['esty'],
}

METRICS_PER_TYPE = {
    'jvae': ['rmse', 'dB', 'sigma'],
    'cvae': ['rmse', 'dB', 'd-mind', 'ld-norm', 'sigma'],
    'xvae': ['rmse', 'dB', 'zdist', 'd-mind', 'ld-norm', 'sigma'],
    'vae': ['rmse', 'dB', 'sigma'],
    'vib': ['sigma'],
}

OOD_METHODS_PER_TYPE = {
    'cvae': ['iws-2s', 'iws-a-1-1', 'iws-a-4-1', 'iws', 'mse', 'elbo', 'soft',
             'elbo-2s', 'elbo-a-1-1', 'elbo-a-4-1', 'zdist'],
    'xvae': ['max', 'mean', 'std'],
    'jvae': ['max', 'sum', 'std'],
    'vae': ['iws', 'iws-2s', 'iws-a-1-1', 'iws-a-4-1',
            'elbo', 'elbo-2s', 'elbo-a-1-1', 'elbo-a-4-1', 'zdist'],
    'vib': ['odin*', 'baseline', 'logits'],
}

MISCLASS_METHODS_PER_TYPE = {
    'cvae': ['softkl*', 'iws', 'softiws*', 'kl', 'max', 'zdist', 'softzdist*',
             'baseline*', 'hyz'],
    'xvae': [],
    'jvae': [],
    'vae': [],
    'vib': ['odin*', 'baseline', 'logits', 'hyz'],
}

# ODIN parameter grids (ref cvae.py:120-133)
ODIN_TEMPS = [t * 10 ** i for i in (0, 1, 2) for t in (1, 2, 5)] + [1000]
ODIN_EPS = [e / 20 * 0.004 for e in range(21)]

METHODS_PARAMS: Dict[str, list] = {
    'odin': ['odin-{:.0f}-{:.4f}'.format(T, e) for T in ODIN_TEMPS for e in ODIN_EPS],
}
for _k in ('softkl', 'softzdist', 'softiws', 'baseline'):
    METHODS_PARAMS[_k] = ['{}-{:.0f}'.format(_k, T) for T in ODIN_TEMPS]


@dataclasses.dataclass(frozen=True)
class CVNetConfig:
    input_shape: Tuple[int, ...]
    num_labels: int
    type: str = 'cvae'
    y_is_coded: bool = False
    output_distribution: str = 'gaussian'   # gaussian | categorical
    features: Optional[str] = None          # conv DSL string or named arch
    batch_norm: Any = False                 # False | 'encoder' | 'both'
    dropout: float = 0.0
    encoder: Tuple[int, ...] = (36,)
    latent_dim: int = 32
    prior: PriorConfig = None
    beta: float = 1.0
    gamma: float = 0.0
    decoder: Tuple[int, ...] = (36,)
    upsampler: Optional[str] = None
    classifier: Tuple = (36,)
    name: str = 'joint-vae'
    activation: str = DEFAULT_ACTIVATION
    latent_sampling: int = DEFAULT_LATENT_SAMPLING
    test_latent_sampling: int = 0           # 0 -> same as latent_sampling
    encoder_forced_variance: float = 0.0
    output_activation: str = DEFAULT_OUTPUT_ACTIVATION
    sigma: SigmaConfig = None
    representation: str = 'rgb'
    version: str = VERSION
    iws_mode: str = 'reference'             # 'reference' quirk | 'lme' correct
    compute_dtype: str = 'float32'          # 'float32' | 'bfloat16'

    def __post_init__(self):
        if self.type not in ('jvae', 'cvae', 'xvae', 'vib', 'vae'):
            raise ValueError('unknown type {}'.format(self.type))
        if self.y_is_coded and self.type in ('vib', 'vae'):
            raise ValueError('{} does not code y'.format(self.type))
        object.__setattr__(self, 'input_shape', tuple(self.input_shape))
        object.__setattr__(self, 'encoder', tuple(self.encoder))
        object.__setattr__(self, 'decoder', tuple(self.decoder))
        object.__setattr__(self, 'classifier', tuple(self.classifier))
        if self.sigma is None:
            object.__setattr__(self, 'sigma', SigmaConfig(value=1.0))
        prior = self.prior
        if prior is None:
            prior = PriorConfig(dim=self.latent_dim)
        if self.type in ('cvae', 'xvae') and prior.num_priors == 1:
            prior = dataclasses.replace(prior, num_priors=self.num_labels)
        if prior.dim != self.latent_dim:
            prior = dataclasses.replace(prior, dim=self.latent_dim)
        object.__setattr__(self, 'prior', prior)
        if not self.test_latent_sampling:
            object.__setattr__(self, 'test_latent_sampling', self.latent_sampling)
        if not self.x_is_generated:
            object.__setattr__(self, 'decoder', ())
            object.__setattr__(self, 'upsampler', None)
            object.__setattr__(self, 'output_distribution', None)
        if not self.y_is_decoded:
            object.__setattr__(self, 'classifier', ())
        if self.upsampler and not self.features:
            raise ValueError('no upsampler without features')

    # --- type flags (ref cvae.py:188-230) ---
    @property
    def is_jvae(self): return self.type == 'jvae'

    @property
    def is_vib(self): return self.type == 'vib'

    @property
    def is_vae(self): return self.type == 'vae'

    @property
    def is_cvae(self): return self.type == 'cvae'

    @property
    def is_xvae(self): return self.type == 'xvae'

    @property
    def y_is_decoded(self) -> bool:
        if self.is_cvae or self.is_vae:
            return bool(self.gamma)
        return True

    @property
    def x_is_generated(self) -> bool:
        return not self.is_vib

    @property
    def losses_per_class(self) -> bool:
        return not self.is_vae and not self.is_vib

    @property
    def has_batch_norm(self) -> bool:
        return bool(self.features) and (
            self.batch_norm in ('encoder', 'both')
            or str(self.features).startswith(('resnet', 'densenet')))

    @property
    def classifier_type(self) -> Optional[str]:
        if not self.y_is_decoded:
            return None
        if (self.is_cvae and self.classifier
                and isinstance(self.classifier[0], str)):
            if self.classifier[0] != 'softmax':
                raise ValueError(self.classifier[0])
            return self.classifier[0]
        return 'linear'

    @property
    def loss_components(self) -> Tuple[str, ...]:
        lc = LOSS_COMPONENTS_PER_TYPE[self.type]
        if self.y_is_decoded and 'cross_y' not in lc:
            lc = lc + ('cross_y',)
        return lc

    @property
    def predict_methods(self):
        m = list(PREDICT_METHODS_PER_TYPE[self.type])
        if self.y_is_decoded and 'esty' not in m:
            m.append('esty')
        return m

    @property
    def ood_methods(self):
        return list(OOD_METHODS_PER_TYPE[self.type])

    @property
    def misclass_methods(self):
        return list(MISCLASS_METHODS_PER_TYPE[self.type])

    @property
    def metrics(self):
        return list(METRICS_PER_TYPE[self.type])

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == 'bfloat16' else torch.float32

    @property
    def sigma_cfg(self) -> SigmaConfig:
        return self.sigma

    @property
    def depth(self) -> int:
        return (len(self.encoder) + len(self.decoder)
                + (len(self.classifier) if self.classifier_type == 'linear' else 0))

    @property
    def width(self) -> int:
        clf = [d for d in self.classifier if isinstance(d, int)]
        return (sum(self.encoder) + sum(self.decoder)
                + (sum(clf) if self.classifier_type == 'linear' else 0))

    @property
    def architecture(self) -> Dict[str, Any]:
        """params.json architecture dict (ref cvae.py:348-378)."""
        d = {'input_shape': list(self.input_shape),
             'num_labels': self.num_labels,
             'output_distribution': self.output_distribution,
             'type': self.type,
             'representation': self.representation,
             'encoder': list(self.encoder),
             'batch_norm': self.batch_norm,
             'dropout': self.dropout,
             'activation': self.activation,
             'encoder_forced_variance': self.encoder_forced_variance,
             'latent_dim': self.latent_dim,
             'test_latent_sampling': self.test_latent_sampling,
             'prior': self.prior.params,
             'decoder': list(self.decoder),
             'upsampler': self.upsampler,
             'classifier': list(self.classifier),
             'output_activation': self.output_activation,
             'y_is_coded': self.y_is_coded,
             'iws_mode': self.iws_mode,
             'compute_dtype': self.compute_dtype,
             'version': self.version}
        if self.features:
            d['features'] = self.features
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any], **overrides) -> 'CVNetConfig':
        """Build from a params.json-style architecture dict."""
        d = dict(d)
        d.pop('version', None)
        prior = d.pop('prior', None)
        if isinstance(prior, dict):
            p = dict(prior)
            dim = p.pop('dim', d.get('latent_dim', 32))
            dist = p.pop('distribution', 'gaussian')
            d['prior'] = build_prior_config(dim, dist, **p)
        sigma = d.pop('sigma', None)
        if isinstance(sigma, dict):
            sigma = dict(sigma)
            sigma.pop('value_', None)
            if sigma.get('input_dim'):
                sigma['input_dim'] = tuple(sigma['input_dim'])
            known_s = {f.name for f in dataclasses.fields(SigmaConfig)}
            d['sigma'] = SigmaConfig(**{k: v for k, v in sigma.items()
                                        if k in known_s})
        elif sigma is not None:
            d['sigma'] = SigmaConfig(value=sigma)
        if 'y_is_coded' not in d:
            d['y_is_coded'] = d.get('type') in ('jvae', 'xvae')
        d.update(overrides)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def flagship_config(tiny: bool = False,
                    compute_dtype: str = 'float32') -> CVNetConfig:
    """The repo's flagship model: CIFAR-100 cvae with conv32 features, a
    deconv32 upsampler, widths 512, K=128, a learned 100-class gaussian
    prior and test L=16 (same values as ``__graft_entry__._flagship_cfg``),
    computing in ``compute_dtype`` ('float32' or 'bfloat16', the bench's
    default).  ``tiny`` gives its small test twin (float32, as JAX's)."""
    if tiny:
        return CVNetConfig(
            input_shape=(3, 8, 8), num_labels=4, type='cvae',
            features='[x3+1]8-8:2', upsampler='[x3+1]8x2+0-8:2++1-!3x3+1',
            encoder=(32,), decoder=(36,), classifier=(16,),
            latent_dim=16, latent_sampling=1, test_latent_sampling=2,
            gamma=100.0, beta=1e-3, sigma=SigmaConfig(value=0.3),
            prior=PriorConfig(dim=16, num_priors=4, init_mean=1.0,
                              learned_means=True))
    return CVNetConfig(
        input_shape=(3, 32, 32), num_labels=100, type='cvae',
        features='conv32', upsampler='deconv32',
        encoder=(512,), decoder=(512,), classifier=(),
        latent_dim=128, latent_sampling=1, test_latent_sampling=16,
        gamma=500.0, beta=1e-4, sigma=SigmaConfig(value=0.1),
        prior=PriorConfig(dim=128, num_priors=100, init_mean=17.0,
                          learned_means=True),
        compute_dtype=compute_dtype)


def imagenet64_config(compute_dtype: str = 'float32') -> CVNetConfig:
    """The repo's second geometry (``bench.py``'s ``JVT_BENCH_GEOM=
    imagenet64``): an ImageNet-subset cvae with vgg16 features on 3x64x64
    crops, a [x4:2+1] sub-pixel upsampler with a 5x5 head, widths 2048,
    K=256, a learned 1000-class gaussian prior and test L=16 (same values
    as ``__graft_entry__._imagenet64_cfg``), computing in
    ``compute_dtype``."""
    return CVNetConfig(
        input_shape=(3, 64, 64), num_labels=1000, type='cvae',
        features='vgg16',
        upsampler='[x4:2+1]512x4:1+0-256-128-64-32-!3x5:1+2',
        encoder=(2048,), decoder=(2048,), classifier=(),
        latent_dim=256, latent_sampling=1, test_latent_sampling=16,
        gamma=1000.0, beta=1e-4, sigma=SigmaConfig(value=0.1),
        prior=PriorConfig(dim=256, num_priors=1000, init_mean=17.0,
                          learned_means=True),
        compute_dtype=compute_dtype)


class _DenseImager(nn.Module):
    """Linear imager when there is no deconv upsampler."""

    def __init__(self, in_features: int, out_shape: Tuple[int, ...],
                 factor: int, output_activation: str, dtype):
        super().__init__()
        self.out_shape = tuple(out_shape)
        self.factor = factor
        self.act = ACTIVATIONS[output_activation]
        self.dense = Dense(in_features, factor * int(np.prod(out_shape)), dtype)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        x = self.act(self.dense(u))
        lead = x.shape[:-1]
        if self.factor == 256:
            return x.reshape(lead + (256,) + self.out_shape)
        return x.reshape(lead + self.out_shape)


class CVNet(nn.Module):
    """The model; submodule names follow the JAX parameter tree."""

    def __init__(self, cfg: CVNetConfig):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        bn_encoder = cfg.batch_norm in ('encoder', 'both') and bool(cfg.features)
        bn_decoder = cfg.batch_norm == 'both' and bool(cfg.features)

        if cfg.features and cfg.features.startswith(('resnet', 'densenet')):
            self.features_stack = build_trunk(cfg.features, cfg.input_shape,
                                              dtype)
            encoder_input_shape = self.features_stack.output_shape
        elif cfg.features:
            _, plans, out_shape = conv_stack_plan(
                cfg.input_shape, cfg.features, where='input',
                batch_norm=bn_encoder, activation=cfg.activation)
            self.features_stack = ConvStack(cfg.input_shape, plans,
                                            where='input', dtype=dtype)
            encoder_input_shape = out_shape
        else:
            self.features_stack = None
            encoder_input_shape = cfg.input_shape
        self.encoder_input_shape = tuple(encoder_input_shape)

        sigma_head = (int(np.prod(cfg.sigma_cfg.output_dim))
                      if cfg.sigma_cfg.coded else 0)
        self.encoder = Encoder(
            int(np.prod(encoder_input_shape)), cfg.latent_dim, cfg.num_labels,
            cfg.encoder, y_is_coded=cfg.y_is_coded, activation=cfg.activation,
            sigma_output_dim=sigma_head,
            forced_variance=cfg.encoder_forced_variance, dtype=dtype,
            dropout=cfg.dropout)

        self.decoder = self.imager = None
        if cfg.x_is_generated:
            self.decoder = MLP(cfg.latent_dim, cfg.decoder, cfg.activation, dtype,
                               cfg.dropout)
            imager_input_dim = self.decoder.out_features
            if cfg.upsampler:
                hw = find_input_shape(cfg.upsampler, cfg.input_shape[1:])
                f = hw[0] * hw[1]
                if imager_input_dim % f:
                    raise ValueError('Could not go from {} to *, {} {}'.format(
                        imager_input_dim, *hw))
                imager_in = (imager_input_dim // f, *hw)
                _, plans, _ = conv_stack_plan(
                    imager_in, cfg.upsampler, where='output',
                    batch_norm=bn_decoder, activation=cfg.activation,
                    output_activation=cfg.output_activation,
                    output_distribution=cfg.output_distribution)
                self.imager_input_shape = imager_in
                self.imager = ConvStack(imager_in, plans, where='output',
                                        output_distribution=cfg.output_distribution,
                                        dtype=dtype)
            else:
                self.imager_input_shape = (imager_input_dim,)
                f = 1 if cfg.output_distribution == 'gaussian' else 256
                self.imager = _DenseImager(imager_input_dim, cfg.input_shape, f,
                                           cfg.output_activation, dtype)

        self.classifier = None
        if cfg.classifier_type in ('linear', None):
            clf = tuple(d for d in cfg.classifier if isinstance(d, int))
            self.classifier = Classifier(cfg.latent_dim, cfg.num_labels, clf,
                                         cfg.activation, dtype)

        self.prior = PriorParams(cfg.prior)
        if cfg.sigma_cfg.learned and not cfg.sigma_cfg.coded:
            v0 = (math.log(cfg.sigma_cfg.value) if cfg.sigma_cfg.value > 0
                  else -30.0)
            self.sigma_param = nn.Parameter(
                torch.full((cfg.sigma_cfg.sdim,), v0, dtype=torch.float32))

    # ------ sub-applies ------
    # ``train`` switches the MLPs' dropout (drawn from ``generator``) and
    # the conv stacks' BatchNorm to training; ``bn_train`` overrides it for
    # the conv imager only, and ``bn_updates`` collects the new BatchNorm
    # running statistics (``models/conv.py``).

    def features(self, x: torch.Tensor, train: bool = False,
                 bn_updates: Optional[dict] = None) -> torch.Tensor:
        if self.cfg.representation == 'hsv' and x.shape[-3] == 3:
            from .representation import rgb2hsv
            x = rgb2hsv(x)
        if self.features_stack is None:
            return x
        return self.features_stack(x, train, bn_updates)

    def encode(self, t: torch.Tensor, y_onehot: Optional[torch.Tensor] = None,
               train: bool = False,
               generator: Optional[torch.Generator] = None):
        """t (..., *encoder_input_shape) -> (mu, log_var, sigma_coded)."""
        flat = t.reshape(t.shape[:t.ndim - len(self.encoder_input_shape)] + (-1,))
        return self.encoder(flat, y_onehot, train, generator)

    def decode(self, z: torch.Tensor, train: bool = False,
               bn_train: Optional[bool] = None,
               generator: Optional[torch.Generator] = None,
               bn_updates: Optional[dict] = None) -> torch.Tensor:
        """z (..., K) -> reconstruction (..., [256,] *input_shape)."""
        u = self.decoder(z, train, generator)
        if isinstance(self.imager, ConvStack):
            lead = u.shape[:-1]
            out = self.imager(u.reshape((-1,) + tuple(self.imager_input_shape)),
                              train if bn_train is None else bn_train,
                              bn_updates)
            return out.reshape(lead + out.shape[1:])
        return self.imager(u)

    def classify(self, z: torch.Tensor) -> torch.Tensor:
        if self.cfg.classifier_type == 'softmax':
            # gaussian-dictionary classifier (ref cvae.py:499, bias sign kept)
            m = self.prior()['mean'].to(z.dtype)
            return (torch.matmul(z, m.T)
                    + 0.5 * torch.sum(torch.square(m), dim=-1))
        return self.classifier(z)


def init_weights(model: CVNet, seed: int) -> CVNet:
    """Fill the model with fresh weights from a numpy generator: lecun
    normal kernels, zero biases, the config's prior init, unit BN."""
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    with torch.no_grad():
        for _, mod in model.named_modules():
            if isinstance(mod, Dense):
                fan_in = mod.in_features
                w = rng.standard_normal((mod.out_features, fan_in)) / math.sqrt(fan_in)
                mod.weight.copy_(torch.from_numpy(w.astype(np.float32)))
                mod.bias.zero_()
            elif isinstance(mod, (ConvLayer, TrunkConv)):
                kh, kw, cin, cout = mod.to_hwio(mod.weight).shape
                k = rng.standard_normal((kh, kw, cin, cout)) / math.sqrt(kh * kw * cin)
                mod.weight.copy_(mod.from_hwio(torch.from_numpy(k.astype(np.float32))))
                if isinstance(mod, ConvLayer):
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        prior = init_prior_arrays(cfg.prior, rng)
        model.prior.mean.copy_(torch.from_numpy(prior['mean']))
        model.prior.var_param.copy_(torch.from_numpy(prior['var_param']))
    return model
