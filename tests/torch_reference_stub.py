"""A stub moxime/joint-vae checkout, for the export tests and
``chip_smoke.py``: the narrow part of the reference that both packages'
exporters use (``save_load/export_reference.py``), written into a
directory laid out as the real checkout:

    cvae.py                       ClassificationVariationalNetwork: its
                                  ctor, ``load(dir, load_state=...)``,
                                  ``state_dict()``, ``.optimizer``
    module/vae_layers/conv.py     build_de_conv_layers, ResOrDenseNetFeatures
    module/vae_layers/layers.py   Sigma (the Parameter subclass)
    utils/save_load/recorders.py  LossRecorder, SampleRecorder and their
                                  save (``torch.save`` of ``__dict__``)

The network rebuilds from the exported ``params.json`` and
``train_params.json`` as the reference's load does (its train keys
popped, the rest passed to the ctor); its ``state_dict()`` and
``optimizer.state_dict()`` are the templates that
``torch_reference_layout.reference_state_dict`` / ``reference_optimizer``
give for a port model of that configuration (weights from a numpy seed),
the torchvision trunk built through ``torchvision.models.<name>()`` as
the reference builds it (a stub of torchvision takes the exporters'
``tv_resnet`` factories).  The routing of ``build_de_conv_layers`` is the
reference's, bug included: only ``resnet*`` names reach
``ResOrDenseNetFeatures``, and a ``densenet*`` name falls through to the
conv-layer parser, which refuses it (ref conv.py:138), so a densenet121
job's template builds only through ``tv_resnet.route_densenet``.  The
ctor takes the architecture keys of a params.json (``CVNetConfig.
architecture``) but ``compute_dtype``, which the reference does not know,
and the training keys sigma, beta, gamma, latent_sampling and optimizer.

Imports neither jax nor the JAX package.
"""

import json
import os
import tempfile
from collections import OrderedDict

import numpy as np
import torch

from joint_vae_tpu_torch.models.cvnet import CVNetConfig
from joint_vae_tpu_torch.save_load.from_jax import state_dict_to_jax
from joint_vae_tpu_torch.save_load.jobs import new_job
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig

from torch_reference_layout import reference_optimizer, reference_state_dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# train_params.json keys the reference's load() pops before it calls the
# ctor (ref cvae.py:2788-2801)
TRAIN_KEYS_OUT = (
    'set', 'epochs', 'data_augmentation', 'batch_size', 'fine_tuning',
    'warmup', 'warmup_gamma', 'full_test_every', 'validation_split_seed',
    'max_batch_sizes', 'pretrained_features', 'pretrained_upsampler',
    'transformer', 'validation')

CTOR_KEYS = ('input_shape', 'num_labels', 'output_distribution', 'type',
             'representation', 'encoder', 'batch_norm', 'dropout',
             'activation', 'encoder_forced_variance', 'latent_dim',
             'test_latent_sampling', 'prior', 'decoder', 'upsampler',
             'classifier', 'output_activation', 'y_is_coded', 'iws_mode',
             'features', 'sigma', 'beta', 'gamma', 'latent_sampling',
             'optimizer')

_CVAE = '''"""Stub of moxime/joint-vae's cvae.py (tests/torch_reference_stub.py)."""
import sys

for _p in {paths!r}:
    if _p not in sys.path:
        sys.path.append(_p)

from module.vae_layers.conv import build_de_conv_layers
import torch_reference_stub as _stub


class ClassificationVariationalNetwork:

    def __init__(self, {args}):
        kw = {{k: v for k, v in locals().items() if k != 'self'}}
        features = kw.get('features')
        trunk = (build_de_conv_layers(kw['input_shape'], features,
                                      where='input') if features else None)
        _stub.build(self, kw, trunk)

    @classmethod
    def load(cls, dir_name, load_state=True):
        return _stub.load(cls, dir_name, load_state)

    def state_dict(self):
        return self._state_dict
'''

_CONV = '''"""Stub of moxime/joint-vae's module/vae_layers/conv.py."""
import torch.nn as nn
import torchvision


class ResOrDenseNetFeatures(nn.Sequential):
    """A torchvision trunk without its head (ref conv.py:247-272)."""

    def __init__(self, model_name='resnet18', input_shape=(3, 32, 32),
                 pretrained=False):
        model = getattr(torchvision.models, model_name)(pretrained=pretrained)
        super().__init__(*list(model.children())[:-1])
        self.name = model_name
        self.input_shape = tuple(input_shape)


def build_de_conv_layers(input_shape, layers_name, batch_norm=False,
                         where='input', **kw):
    """The reference's routing: only resnet* names reach the trunk class
    (ref conv.py:138); the conv-layer parser refuses a densenet name.
    Other names are conv-layer specs, built by the port's model."""
    name = str(layers_name)
    if where == 'input' and name.startswith('resnet'):
        return ResOrDenseNetFeatures(model_name=name,
                                     input_shape=input_shape)
    if name.startswith('densenet'):
        raise ValueError('{{}} is not a conv layer spec'.format(name))
    return None
'''

_LAYERS = '''"""Stub of moxime/joint-vae's module/vae_layers/layers.py."""
import torch


class Sigma(torch.nn.Parameter):
    pass
'''

_RECORDERS = '''"""Stub of moxime/joint-vae's utils/save_load/recorders.py: the
recorders' state and their save, ``torch.save`` of ``__dict__`` with the
tensors cut to the recorded batches (ref recorders.py:107-138)."""
import torch


class LossRecorder:
    """Batch axis last."""

    axis = -1

    def __init__(self, batch_size, num_batch=0, device=None, **tensors):
        self.batch_size = batch_size
        self._num_batch = num_batch
        self._recorded_batches = 0
        self._seed = None
        self.last_batch_size = batch_size
        self.device = device
        self._tensors = {{k: self._empty(t, num_batch * batch_size)
                         for k, t in tensors.items()}}

    def _empty(self, t, n):
        shape = list(t.shape)
        shape[self.axis] = n
        return torch.zeros(shape, dtype=t.dtype)

    def _cut(self, t, end):
        return (t[..., :end] if self.axis == -1 else t[:end]).clone()

    def __len__(self):
        return self._recorded_batches

    def save(self, file_path, cut=True):
        if cut:
            end = len(self) * self.batch_size
            self._num_batch = len(self)
            self._tensors = {{k: self._cut(t, end)
                             for k, t in self._tensors.items()}}
        torch.save(self.__dict__, file_path)


class SampleRecorder(LossRecorder):
    """Sample axis first, with auxiliary tensors beside."""

    axis = 0

    def __init__(self, batch_size, num_batch=0, device=None, **tensors):
        super().__init__(batch_size, num_batch, device, **tensors)
        self._aux = {{}}

    def add_auxiliary(self, **aux):
        self._aux.update(aux)
'''


class _Optimizer:
    def __init__(self, sd):
        self._sd = sd

    def state_dict(self):
        return self._sd


def build(net, kw, trunk):
    """The stub network's state: the port model of the configuration in
    ``kw`` (a numpy seed), the trunk's weights in place of its features,
    the templates."""
    kw = {k: v for k, v in kw.items() if v is not None}
    opt = dict(kw.pop('optimizer', None) or {})
    cfg = CVNetConfig.from_dict(kw)
    job = new_job(cfg, OptimizerConfig(lr=opt.get('lr') or 0.0), seed=0,
                  device='cpu')
    arrays = state_dict_to_jax(job.model)
    arrays['sigma_state/data'] = job.sigma_state.data.numpy()
    seq = None
    if trunk is not None:
        seq = torch.nn.Sequential(*trunk, torch.nn.Identity())
    sd = reference_state_dict(arrays, seq)
    net._state_dict = OrderedDict((k, torch.from_numpy(np.array(v)))
                                  for k, v in sd.items())
    net.optimizer = _Optimizer(reference_optimizer(
        sd, arrays, {}, {'lr': job.opt_cfg.lr}))


def load(cls, dir_name, load_state=True):
    """The reference's load: params.json to the ctor with the train
    params its load keeps, torch's generator seeded for the trunk's
    template (and restored); ``load_state`` reads state.pth, which must
    hold every key of the template (``loaded_state``)."""
    with open(os.path.join(dir_name, 'params.json')) as f:
        params = json.load(f)
    params.pop('version', None)
    job_number = params.pop('job_number', None)
    tp = {}
    p = os.path.join(dir_name, 'train_params.json')
    if os.path.exists(p):
        with open(p) as f:
            tp = {k: v for k, v in json.load(f).items()
                  if k not in TRAIN_KEYS_OUT and not k.startswith('early-')}
    with torch.random.fork_rng():
        torch.manual_seed(0)
        net = cls(**params, **tp)
    net.job_number = job_number
    if load_state:
        sd = torch.load(os.path.join(dir_name, 'state.pth'),
                        map_location='cpu', weights_only=False)
        missing = set(net._state_dict) - set(sd)
        if missing:
            raise KeyError('missing keys in state.pth: {}'.format(
                sorted(missing)))
        net.loaded_state = sd
    return net


def write_stub_checkout(root: str) -> str:
    """Write the stub checkout under ``root``; returns ``root``."""
    files = {
        'cvae.py': _CVAE.format(paths=[ROOT, HERE], args=', '.join(
            k + '=None' for k in CTOR_KEYS)),
        'module/__init__.py': '',
        'module/vae_layers/__init__.py': '',
        'module/vae_layers/conv.py': _CONV.format(),
        'module/vae_layers/layers.py': _LAYERS,
        'utils/__init__.py': '',
        'utils/save_load/__init__.py': '',
        'utils/save_load/recorders.py': _RECORDERS.format(),
    }
    for rel, text in files.items():
        path = os.path.join(root, *rel.split('/'))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'w') as f:
            f.write(text)
    return root


_CHECKOUT = []


def stub_checkout() -> str:
    """This process's stub checkout, written once (the checkout's modules
    are imported once per process, under their top-level names)."""
    if not _CHECKOUT:
        _CHECKOUT.append(write_stub_checkout(
            tempfile.mkdtemp(prefix='jvt-reference-stub-')))
    return _CHECKOUT[0]
