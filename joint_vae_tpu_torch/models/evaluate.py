"""The evaluation engine: forward + losses + measures for all five types,
at inference and in training.

Port of ``joint_vae_tpu/models/evaluate.py`` (ref cvae.py:523-917).  The
(L+1) latent-sample axis and the C class axis are broadcast dims: per-class evaluation of a cvae runs the encoder and
decoder once per input and the class axis enters through the prior; for
y-coded types (jvae/xvae) features are computed once and broadcast along C
before the encoder.  ``iws_mode='reference'`` keeps the reference's
published estimator (mean(exp(delta)) + max), 'lme' the log-mean-exp.

The per-class IWAE combine of a class-conditional gaussian prior with
scalar variance goes through :func:`ops.iws.iws_combine` (the CUDA kernel
on the card); every other combine is plain PyTorch.  In training
(``train=True``) gradients are on, the mean sample is not decoded, the
KL carries beta and the warmup weights, cross_y enters the total for
cvae/vae too, the sigma state tracks the rmse and BatchNorm uses batch
statistics (their running updates returned when asked).

Loss shapes: per-class (C, N); per-input (N,); 'total' broadcasts.
"""

import dataclasses
import math
import contextlib
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.iws import iws_combine
from ..ops.losses import categorical_loss, mse_loss, x_loss
from ..ops.priors import Params, PriorConfig, prior_kl, prior_log_density
from ..ops.sampling import draw_epsilon, reparameterize
from ..ops.sigma import (SigmaState, sigma_value, update_sigma_coded,
                         update_sigma_rmse)
from ..parallel.mesh import gather_uneven, sample_blocks, sample_split
from .conv import ConvStack
from .cvnet import CVNet
from .layers import capacity, dict_min_distance, onehot_encoding

_LOG_2PI = math.log(2 * math.pi)


@dataclasses.dataclass
class EvalOutput:
    x_reco: torch.Tensor               # (L+1 or L, [C,] N, [256,] *input_shape)
    logits: torch.Tensor               # ([C,] N, num_labels), mean over samples 1:
    losses: Dict[str, torch.Tensor]    # each (N,) or (C, N)
    measures: Dict[str, torch.Tensor]  # scalar diagnostics for this batch
    mu: torch.Tensor
    log_var: torch.Tensor
    z: torch.Tensor
    sigma_state: SigmaState


def draw_eval_epsilon(cfg, n: int, L: Optional[int] = None, *,
                      generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """The (L+1, [C,] n, K) latent noise (row 0 zeros) that
    :func:`evaluate` draws from ``generator`` for a batch of ``n`` inputs
    without labels at inference (``train=False``, where it is the only
    draw): the same numbers, in the same dtype, so that passing it as
    ``eps`` gives the same evaluation and leaves the generator where the
    call would (a y-coded type's leading class axis included).  ``L``
    defaults to the config's test L."""
    L = cfg.test_latent_sampling if L is None else L
    shape = ((cfg.num_labels,) if cfg.y_is_coded else ()) + (
        n, cfg.latent_dim)
    dist = 'uniform' if cfg.prior.distribution == 'uniform' else 'gaussian'
    return draw_epsilon(shape, L, dist, generator=generator, device=device,
                        dtype=cfg.dtype)


def evaluate(model: CVNet, x: torch.Tensor, y: Optional[torch.Tensor] = None,
             *, sigma_state: SigmaState,
             train: bool = False,
             with_beta: bool = False,
             kl_var_weighting: Union[float, torch.Tensor] = 1.0,
             gamma_weighting: Union[float, torch.Tensor] = 1.0,
             L: Optional[int] = None,
             compute_iws: Optional[bool] = None,
             return_bn_updates: bool = False,
             decode_mean: bool = True,
             bn_eval: bool = False,
             native_scores: bool = False,
             prior_override: Optional[Tuple[PriorConfig, Params]] = None,
             eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
    """Evaluate a batch; returns EvalOutput, and with ``return_bn_updates``
    also the BatchNorm running statistics of a training pass as
    ``{module: (mean, var)}`` (``models/conv.py::apply_bn_updates``).

    x (N, *input_shape); y (N,) int labels or None (per-class evaluation).
    ``eps`` (L+1, *mu.shape) injects the latent noise (row 0 zeros);
    otherwise it is drawn from ``generator``, as is the dropout mask.
    ``kl_var_weighting`` / ``gamma_weighting`` (the warmup ramps) are
    floats or 0-dim float64 tensors on the device, which a captured train
    step reads as the epochs move (``train/steps.py``); a float64 ramp
    scales a float32 tensor as the same Python float does.
    ``decode_mean=False`` skips decoding the mean sample (scoring-only
    callers; training never decodes it).  ``compute_iws`` defaults to
    ``not train``.  ``bn_eval`` keeps BatchNorm on its running statistics
    while the rest trains.  Gradients are enabled only in training.
    ``prior_override`` ``(prior_cfg, prior_params)`` replaces the model's
    prior in the KL, the class-dictionary diagnostics and the IWAE term
    (the WIM alternate prior, ``ft/wim.py``); the latent noise keeps the
    model's prior's distribution.
    ``native_scores`` follows the JAX package's flag.  A string holding
    'bf16' takes the difference and square of the (L, ...) gaussian
    reconstructions in the compute dtype and their mean in float32 (with
    one scalar sigma, as the unweighted mse over sigma^2), which moves a
    bfloat16 model's losses by its rounding and leaves float32 models as
    they are; 'barrier' is an XLA scheduling hint with no numeric effect,
    accepted and ignored; True is JAX's native layout, which only
    permutes the summed pixels: the port computes in NCHW in every case."""
    grad_ctx = contextlib.nullcontext() if train else torch.no_grad()
    with grad_ctx:
        return _evaluate(model, x, y, sigma_state=sigma_state, train=train,
                         with_beta=with_beta,
                         kl_var_weighting=kl_var_weighting,
                         gamma_weighting=gamma_weighting, L=L,
                         compute_iws=compute_iws,
                         return_bn_updates=return_bn_updates,
                         decode_mean=decode_mean, bn_eval=bn_eval,
                         native_scores=native_scores,
                         prior_override=prior_override, eps=eps,
                         generator=generator)


def _evaluate(model, x, y, *, sigma_state, train, with_beta, kl_var_weighting,
              gamma_weighting, L, compute_iws, return_bn_updates, decode_mean,
              bn_eval, native_scores, prior_override, eps, generator):
    cfg = model.cfg
    C = cfg.num_labels
    N = x.shape[0]
    x = x.float()

    y_in_input = y is not None
    x_rep = cfg.y_is_coded and not y_in_input
    per_class = cfg.losses_per_class and not y_in_input
    if compute_iws is None:
        compute_iws = not train
    if L is None:
        L = cfg.latent_sampling if train else cfg.test_latent_sampling
    # the TRAIN-time L and beta decide whether the latent is stochastic
    sampled = cfg.latent_sampling > 1 or cfg.beta > 0
    # the mean sample's reconstruction is not decoded in training
    decode_mean = decode_mean and not train
    mtrain = train and not bn_eval          # BatchNorm's mode
    bn_updates = {} if (mtrain and return_bn_updates) else None

    if prior_override is not None:
        prior_cfg, prior_params = prior_override
    else:
        prior_cfg, prior_params = cfg.prior, model.prior()

    y_fwd = y
    if x_rep:
        y_fwd = torch.arange(C, device=x.device)[:, None].expand(C, N)

    # ---- forward: features -> encode -> sample -> decode -> classify ----
    t = model.features(x, mtrain, bn_updates)
    if x_rep:
        t = t[None].expand((C,) + t.shape)
    y_onehot = onehot_encoding(y_fwd, C, cfg.dtype) if cfg.y_is_coded else None
    mu, log_var, sigma_coded = model.encode(t, y_onehot, train, generator)
    dist = 'uniform' if cfg.prior.distribution == 'uniform' else 'gaussian'
    z, eps_used = reparameterize(mu, log_var, L, dist, sampled, eps=eps,
                                 generator=generator)
    # a mesh scope with a 'sample' axis: this rank decodes its block of
    # the L+1 samples (17 over 2 ranks: 9 + 8), and the per-sample losses
    # are gathered below before anything consumes them
    ssplit = sample_split() if cfg.x_is_generated else None
    if ssplit is not None:
        smesh, parts, sidx = ssplit
        first = 0 if decode_mean else 1
        dec_sizes = [max(b, first) - max(a, first)
                     for a, b in sample_blocks(z.shape[0], parts)]
        a, b = sample_blocks(z.shape[0], parts)[sidx]
        z_dec = z[max(a, first):max(b, first)]
    else:
        z_dec = z if decode_mean else z[1:]
    if cfg.x_is_generated:
        x_reco = model.decode(z_dec, train, mtrain, generator, bn_updates)
    else:
        x_reco = x
    logits = model.classify(z)
    eps_norm = torch.sum(torch.square(eps_used.float()), dim=-1)

    losses: Dict[str, torch.Tensor] = {}
    measures: Dict[str, torch.Tensor] = {}
    new_sigma_state = sigma_state

    D = int(np.prod(cfg.input_shape))
    nd = len(cfg.input_shape)
    scfg = cfg.sigma_cfg
    sigma_dims = D if scfg.per_dim else 1

    if cfg.x_is_generated:
        x_reco_s = x_reco[1:] if (decode_mean and ssplit is None) else x_reco
        # ---- sigma resolution (ref cvae.py:626-675) ----
        if scfg.coded:
            out_dim = scfg.output_dim
            s_log = sigma_coded.float().reshape(sigma_coded.shape[:-1]
                                                + tuple(out_dim))
            new_sigma_state = update_sigma_coded(scfg, sigma_state, s_log)
            sigma_div = torch.exp(s_log)
            log_sigma_sum = torch.sum(
                s_log.reshape(s_log.shape[:-len(out_dim)] + (-1,)), dim=-1)
        elif scfg.learned:
            s_log = model.sigma_param.float()
            sigma_div = torch.exp(s_log)
            log_sigma_sum = torch.sum(s_log)
            if scfg.per_dim:
                sigma_div = sigma_div.reshape(cfg.input_shape)
        else:
            s_dat = sigma_state.data.float()
            sigma_div = s_dat
            log_sigma_sum = torch.sum(torch.log(torch.clamp(s_dat, min=1e-30)))
            if scfg.per_dim:
                sigma_div = sigma_div.reshape(cfg.input_shape)

        use_unit_sigma = scfg.is_rmse or cfg.output_distribution == 'categorical'
        # the 'bf16' epilogue of JAX's native-layout scoring
        # (models/evaluate.py:171-182, 233-247): the weighted form only
        # where JAX's decoder has a native layout (a conv imager) and
        # sigma is one scalar
        low = (isinstance(native_scores, str) and 'bf16' in native_scores
               and x_reco_s.dtype != torch.float32)
        scalar_native = (not scfg.per_dim and not scfg.coded
                         and isinstance(model.imager, ConvStack))
        if cfg.output_distribution == 'gaussian':
            if use_unit_sigma:
                wmse_l = mse_loss(x_reco_s, x, ndim=nd, batch_mean=False,
                                  low_precision=low)
            elif low and scalar_native:
                wmse_l = mse_loss(x_reco_s, x, ndim=nd, batch_mean=False,
                                  low_precision=True) / torch.square(sigma_div)
            else:
                wmse_l = mse_loss(x_reco_s / sigma_div, x / sigma_div,
                                  ndim=nd, batch_mean=False)
        else:
            cat_ce_l = categorical_loss(x_reco_s, x, ndim=nd, batch_mean=False)
            amax = torch.argmax(x_reco_s, dim=-nd - 1)
            wmse_l = mse_loss(amax.float() / 255.0, x, ndim=nd, batch_mean=False)
        if ssplit is not None:
            # every sample's losses on every rank, in sample order; the
            # mean sample's are dropped as the unsplit decode drops them
            def whole(t):
                t = gather_uneven(t, smesh, 'sample', dec_sizes, 0)
                return t[1:] if decode_mean else t
            wmse_l = whole(wmse_l)
            if cfg.output_distribution != 'gaussian':
                cat_ce_l = whole(cat_ce_l)
            if decode_mean:
                x_reco = gather_uneven(x_reco, smesh, 'sample', dec_sizes, 0)

        if scfg.is_rmse:
            sigma2 = torch.mean(wmse_l, dim=0)
            wmse_l = wmse_l / sigma2[None]
            log_sigma_sum = 0.5 * torch.log(sigma2)
            wmse = torch.mean(wmse_l, dim=0)
            mse = wmse * sigma2
        else:
            wmse = torch.mean(wmse_l, dim=0)
            mse = wmse if use_unit_sigma else \
                wmse * torch.mean(torch.square(sigma_div))

        losses['wmse'] = wmse
        measures['xpow'] = torch.mean(torch.square(x))
        measures['mse'] = torch.mean(mse)

        # ---- cross_x: gaussian NLL or categorical CE (ref cvae.py:773-789) ----
        if cfg.output_distribution == 'gaussian':
            ls = D * log_sigma_sum if scfg.is_rmse else \
                log_sigma_sum * (D / sigma_dims)
            cross_x = 0.5 * D * (wmse + _LOG_2PI) + ls
            log_iws = -0.5 * D * (wmse_l + _LOG_2PI) - ls
        else:
            cross_x = torch.mean(cat_ce_l, dim=0)
            log_iws = -cat_ce_l
        losses['cross_x'] = cross_x
        if train and not scfg.coded:
            new_sigma_state = update_sigma_rmse(
                scfg, new_sigma_state,
                torch.sqrt(torch.clamp(measures['mse'], min=0.0)))

    if cfg.x_is_generated and scfg.learned and not scfg.coded:
        measures['sigma'] = torch.sqrt(torch.mean(torch.square(sigma_div.float())))
    else:
        measures['sigma'] = sigma_value(scfg, new_sigma_state)

    # ---- KL to the prior (ref cvae.py:711-729) ----
    y_for_prior = None
    all_classes = False
    if prior_cfg.conditional:
        if y_in_input:
            y_for_prior = y.long()
        elif x_rep:
            y_for_prior = y_fwd
        else:
            all_classes = True
    kl_components = prior_kl(prior_cfg, prior_params, mu, log_var,
                             y=y_for_prior, var_weighting=kl_var_weighting,
                             all_classes=all_classes)
    losses['kl'] = kl_components['kl']
    losses['zdist'] = kl_components['distance']
    losses['var_kl'] = kl_components['var_kl']
    measures['zdist'] = torch.mean(kl_components['distance'])
    measures['var_kl'] = torch.mean(kl_components['var_kl'])

    # ---- class-dictionary diagnostics (ref cvae.py:747-762) ----
    if prior_cfg.conditional:
        dictionary = prior_params['mean'].float()
        dict_mean = torch.mean(dictionary, dim=0)
        zdist_to_mean = torch.sum(torch.square(mu.float() - dict_mean), dim=-1)
        dict_norm_var = (torch.mean(torch.sum(torch.square(dictionary), dim=1))
                         - torch.sum(torch.square(dict_mean)))
        losses['dzdist'] = zdist_to_mean + dict_norm_var
        measures['imut-zy'] = capacity(dictionary, C)
        measures['ld-norm'] = torch.mean(torch.square(dictionary))
        measures['d-mind'] = dict_min_distance(dictionary)

    # ---- cross_y (ref cvae.py:731-741) ----
    if cfg.y_is_decoded:
        y_for_xloss = None if (per_class and not cfg.y_is_coded) else y_fwd
        losses['cross_y'] = x_loss(y_for_xloss, logits, batch_mean=False)

    # ---- IWAE importance weights (ref cvae.py:793-873) ----
    if compute_iws and cfg.x_is_generated:
        z1 = z[1:].float()                             # (L, [C,] N, K)
        K = log_var.shape[-1]
        log_inv_q = (0.5 * (eps_norm + torch.sum(log_var.float(), dim=-1))
                     + 0.5 * K * _LOG_2PI)             # (L, [C,] N)
        ref_mode = cfg.iws_mode == 'reference'
        if (all_classes and prior_cfg.distribution == 'gaussian'
                and prior_cfg.var_dim == 'scalar'):
            # the per-class combine of the kernel (csrc/iws_combine.cu); on
            # a mesh splitting the classes over 'model', on this rank's
            # block of classes, gathered along C (each class's value is
            # the same bits as in the whole combine)
            local = model.prior.local() if prior_override is None else None
            pparams = local[0] if local is not None else prior_params
            vp = pparams['var_param'].float()
            iws = iws_combine(z1.contiguous(), (log_iws + log_inv_q).contiguous(),
                              pparams['mean'].float().contiguous(),
                              torch.square(vp).contiguous(),
                              (-2.0 * prior_cfg.dim * torch.log(vp)).contiguous(),
                              ref_mode=ref_mode)
            if local is not None:
                iws = local[1](iws)
        else:
            if prior_cfg.conditional:
                if x_rep:
                    yls = y_fwd.expand((L,) + y_fwd.shape)
                    log_p_z_y = prior_log_density(prior_cfg, prior_params, z1,
                                                  y=yls)
                elif y_in_input:
                    log_p_z_y = prior_log_density(prior_cfg, prior_params, z1,
                                                  y=y.long())
                else:
                    log_p_z_y = torch.movedim(
                        prior_log_density(prior_cfg, prior_params, z1,
                                          all_classes=True), 0, 1)
            else:
                log_p_z_y = prior_log_density(prior_cfg, prior_params, z1)
            liw = log_iws
            while liw.ndim < log_p_z_y.ndim:
                liw = liw.unsqueeze(1)
            liw = liw + log_p_z_y
            liq = log_inv_q
            while liq.ndim < liw.ndim:
                liq = liq.unsqueeze(1)
            liw = liw + liq
            m = torch.amax(liw, dim=0)
            d = torch.exp(liw - m[None])
            iws = (torch.mean(d, dim=0) + m) if ref_mode \
                else torch.log(torch.mean(d, dim=0)) + m
        if 'iws' in cfg.loss_components:
            losses['iws'] = iws

    # ---- total (ref cvae.py:744, 875-902) ----
    total = torch.zeros_like(losses['kl'])
    if cfg.x_is_generated:
        total = total + losses['cross_x']
    # cross_y: with gamma, and for cvae/vae in training only
    if (cfg.y_is_decoded and cfg.gamma
            and (train or not (cfg.is_cvae or cfg.is_vae))):
        total = total + (gamma_weighting * cfg.gamma) * losses['cross_y']
    beta = cfg.beta if with_beta else 1.0
    total = total + beta * losses['kl']
    losses['total'] = total

    logits_out = (torch.mean(logits[1:], dim=0) if logits.shape[0] > 1
                  else logits[0])
    out = EvalOutput(x_reco=x_reco, logits=logits_out, losses=losses,
                     measures=measures, mu=mu, log_var=log_var, z=z,
                     sigma_state=new_sigma_state)
    if return_bn_updates:
        return out, (bn_updates or {})
    return out
