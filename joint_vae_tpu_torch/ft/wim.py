"""WIM ("watermarking") alternate-prior fine-tuning.

Port of ``joint_vae_tpu/ft/wim.py`` (ref ``ft/wim.py``):

- the trained model keeps its frozen *original* prior; a frozen
  *alternate* prior (usually unconditional, mean-shifted or tilted) is
  added (``set_alternate_prior``, ref :95-105);
- evaluation on both priors produces '@'-suffixed loss twins
  (``evaluate_on_both_priors``, ref :114-130): a second ``evaluate`` call
  with ``prior_override`` and the same latent noise, drawn once;
- WIM score grammar (ref :132-201): for k in {kl: -1, zdist: -1/2,
  iws: +1, elbo (= -total): +1} with estimated labels y-hat,
    k~   = sign_k * losses[k][y-hat]
    k@   = logsumexp_c(sign_k * losses[k]) - sign_k * losses[k@]
    k~@  = sign_k * losses[k][y-hat]      - sign_k * losses[k@]
    softk~ = softmax_c(sign_k * losses[k])[y-hat]
- ``finetune_batch`` (ref :215-259): L = ELBO(train x, original prior)
  + alpha * ELBO(moving x, alternate prior with y = 0), one backward
  through both evaluations; ``make_finetune_step`` is the same step as a
  CUDA graph on the card (``train/graphs.py``, the counterpart of the
  JAX package's jitted fine-tune step), alpha its constant.

The alternate prior's mean is drawn from ``numpy.random.default_rng``
(``ops/priors.py::init_prior_arrays``); the JAX package draws it from
``jax.random``, so the two packages' priors for one seed differ, and
``ft/job.py`` stores the arrays (``wim_prior.npz``) that either reloads.
"""

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import module_device
from ..models.cvnet import CVNet, CVNetConfig
from ..models.evaluate import draw_eval_epsilon, evaluate
from ..ops.priors import PriorConfig, build_prior_config, init_prior_arrays
from ..parallel.mesh import mesh_scope, split_names
from ..parallel.shard_steps import global_grad_norm, reduce_step
from ..save_load.jobs import Job
from ..train.graphs import StepGraph
from ..train.optimizers import (Optimizer, advance_counts,
                                sync_device_scalars)
from ..train.state import TrainState, named_params
from ..train.steps import copy_sigma_state, graph_mode

WIM_OOD_METHODS_PER_TYPE = {
    'vae': ['zdist', 'elbo', 'kl'],
    'cvae': ['zdist', 'zdist~', 'zdist@', 'zdist~@',
             'elbo', 'elbo~', 'elbo@', 'elbo~@'],
}
WIM_MISCLASS_METHODS_PER_TYPE = {'cvae': ['softzdist~', 'zdist~'], 'vae': []}

K_SIGN = {'kl': -1.0, 'zdist': -0.5, 'iws': 1.0, 'elbo': 1.0}


@dataclasses.dataclass
class WIMJob:
    """A trained Job plus a frozen alternate prior."""
    job: Job
    alternate_prior_cfg: Optional[PriorConfig] = None
    alternate_prior_params: Optional[Dict[str, torch.Tensor]] = None
    ft_params: Dict = dataclasses.field(default_factory=dict)

    @property
    def model(self) -> CVNet:
        return self.job.model

    @property
    def cfg(self) -> CVNetConfig:
        return self.job.model_cfg

    def set_alternate_prior(self, **p):
        """(ref ft/wim.py:95-105): frozen, usually unconditional; its
        arrays drawn from ``numpy.random.default_rng`` of the prior's
        ``seed`` (0 without one), on the model's device."""
        assert self.alternate_prior_cfg is None, 'alternate prior already set'
        p.setdefault('dim', self.cfg.latent_dim)
        dim = p.pop('dim')
        dist = p.pop('distribution', 'gaussian')
        self.alternate_prior_cfg = build_prior_config(dim, dist, **p)
        self.set_alternate_prior_arrays(init_prior_arrays(
            self.alternate_prior_cfg, np.random.default_rng(p.get('seed') or 0)))
        if not self.ft_params:
            self.ft_params = dict(p, dim=dim, distribution=dist)
        return self.alternate_prior_cfg

    def set_alternate_prior_arrays(self, arrays: Dict[str, np.ndarray]):
        """The alternate prior's parameters from host arrays (a stored
        ``wim_prior.npz``, or the JAX package's), on the model's device."""
        dev = self.job.device
        self.alternate_prior_params = {
            k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
            for k, v in arrays.items()}

    @property
    def alternate(self):
        return self.alternate_prior_cfg, self.alternate_prior_params

    # ------------------------------------------------------------------

    def evaluate_on_both_priors(self, x: torch.Tensor, *, sigma_state,
                                L: Optional[int] = None,
                                decode_mean: bool = True,
                                eps: Optional[torch.Tensor] = None,
                                generator: Optional[torch.Generator] = None):
        """(x_reco, logits, losses + '@' twins, measures)
        (ref ft/wim.py:114-130).  Both evaluations take the same latent
        noise, as the JAX package gives both one key: ``eps``, or one draw
        from ``generator`` (``models/evaluate.py::draw_eval_epsilon``, the
        numbers the first evaluation would draw itself) passed to both."""
        model = self.model
        if eps is None:
            eps = draw_eval_epsilon(self.cfg, x.shape[0], L,
                                    generator=generator, device=x.device)
        out = evaluate(model, x, None, sigma_state=sigma_state, train=False,
                       L=L, decode_mean=decode_mean, eps=eps)
        alt = evaluate(model, x, None, sigma_state=sigma_state, train=False,
                       L=L, decode_mean=decode_mean, eps=eps,
                       prior_override=self.alternate)
        losses = dict(out.losses)
        losses.update({k + '@': v for k, v in alt.losses.items()
                       if not k.endswith('~')})
        return out.x_reco, out.logits, losses, out.measures

    def finetune_grads(self, state: TrainState, x_in: torch.Tensor,
                       y_in: torch.Tensor, x_mix: torch.Tensor,
                       alpha: float = 0.1, *,
                       train_L: Optional[int] = None,
                       eps: Optional[torch.Tensor] = None,
                       mesh=None):
        """The fine-tuning objective L = ELBO(x_in, original prior) +
        alpha ELBO(x_mix, alternate prior, y = 0), evaluated in training
        with BatchNorm in inference mode, and its gradient with the
        prior's zeroed.  Returns (grads by parameter name, metrics, the
        in-distribution half's sigma state); the metrics are 0-dim device
        tensors.  ``eps`` (L+1, N, K) injects the latent noise of both
        halves (tests; equal batch sizes); otherwise each half draws its
        own from ``state.generator``.  On a ``mesh`` the batches are this
        rank's rows and the gradients, metrics and sigma statistics are
        averaged over 'data' in one collective (``shard_steps.py``)."""
        model = self.model
        cfg = self.cfg
        params = named_params(model)
        kw = dict(sigma_state=state.sigma_state, train=True, bn_eval=True,
                  with_beta=True, L=train_L, native_scores=True, eps=eps,
                  generator=state.generator)
        with mesh_scope(mesh, rows=True):
            o_in = evaluate(model, x_in, y_in, **kw)
            y_mix = torch.zeros((x_mix.shape[0],), dtype=torch.long,
                                device=x_mix.device)
            o_mix = evaluate(model, x_mix, y_mix,
                             prior_override=self.alternate, **kw)
            in_total = torch.mean(o_in.losses['total'])
            mix_total = torch.mean(o_mix.losses['total'])
            loss = in_total + alpha * mix_total
            got = torch.autograd.grad(loss, list(params.values()),
                                      allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), got)}
        metrics = {'total': loss.detach(), 'in_total': in_total.detach(),
                   'mix_total': mix_total.detach()}
        sigma_state = o_in.sigma_state
        if mesh is not None:
            grads, metrics, sigma_state = reduce_step(
                cfg, mesh, grads, metrics, sigma_state, state.sigma_state,
                o_in.measures.get('mse'))
        return _zero_prior_grads(grads), metrics, sigma_state

    def finetune_batch(self, state: TrainState, x_in: torch.Tensor,
                       y_in: torch.Tensor, x_mix: torch.Tensor,
                       alpha: float = 0.1, *, tx: Optimizer,
                       train_L: Optional[int] = None,
                       eps: Optional[torch.Tensor] = None,
                       mesh=None):
        """One fine-tuning step (ref ft/wim.py:215-259) on
        :meth:`finetune_grads`, eager, updating the model and ``state`` in
        place; returns (state, metrics).  The prior's updates are zeroed
        too, so that weight decay does not move it either; BatchNorm's
        running statistics do not move; the sigma state follows the
        in-distribution half.  ``mesh``: this rank's rows, the global
        batch's step (the clipping norm sums the class-split blocks over
        'model')."""
        step = self.make_finetune_step(alpha, tx=tx, train_L=train_L,
                                       mesh=mesh, graphed=False)
        return step(state, x_in, y_in, x_mix, eps)

    def make_finetune_step(self, alpha: float = 0.1, *, tx: Optimizer,
                           train_L: Optional[int] = None, mesh=None,
                           graphed: Optional[bool] = None):
        """:meth:`finetune_batch` as a step ``step(state, x_in, y_in,
        x_mix, eps=None) -> (state, metrics)``, replayed as a CUDA graph
        on the card unless ``graphed=False`` (``train/graphs.py::
        graph_mode``: a mesh over gloo on a card is eager)."""
        return FinetuneStep(self, alpha, tx, train_L, mesh, graphed)


class FinetuneStep:
    """The WIM fine-tuning step of :meth:`WIMJob.make_finetune_step`: the
    body that a graph captures, the optimizer's device scalars synced
    before it and the host counts advanced after it, once per real
    step."""

    def __init__(self, wim: WIMJob, alpha: float, tx: Optimizer,
                 train_L: Optional[int], mesh, graphed: Optional[bool]):
        self.wim, self.alpha, self.tx = wim, alpha, tx
        self.train_L, self.mesh = train_L, mesh
        self.graph = StepGraph(self._body, name='finetune_step',
                               graphed=graph_mode(graphed, mesh))

    def _body(self, state: TrainState, x_in, y_in, x_mix, eps=None) -> dict:
        model, mesh = self.wim.model, self.mesh
        params = named_params(model)
        grads, metrics, sigma_state = self.wim.finetune_grads(
            state, x_in, y_in, x_mix, self.alpha, train_L=self.train_L,
            eps=eps, mesh=mesh)
        norm = (global_grad_norm(grads, mesh, split_names(model))
                if mesh is not None else None)
        updates, state.opt_state = self.tx.update(
            grads, state.opt_state, params, norm=norm, capturable=True)
        updates = _zero_prior_grads(updates)
        with torch.no_grad():
            torch._foreach_add_(list(params.values()),
                                [updates[k] for k in params])
        copy_sigma_state(state.sigma_state, sigma_state)
        return metrics

    def __call__(self, state: TrainState, x_in: torch.Tensor,
                 y_in: torch.Tensor, x_mix: torch.Tensor,
                 eps: Optional[torch.Tensor] = None):
        sync_device_scalars(state.opt_state, module_device(self.wim.model))
        metrics = self.graph(state, x_in=x_in, y_in=y_in, x_mix=x_mix,
                             eps=eps)
        advance_counts(state.opt_state, self.tx.cfg.optim_type == 'adam')
        state.step += 1
        return state, metrics


def _zero_prior_grads(grads: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Zeros for every tensor of the model's prior (its 'prior' module)."""
    return {k: torch.zeros_like(v) if k.split('.')[0] == 'prior' else v
            for k, v in grads.items()}


def _take(v: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """v[y[n], n] over the class axis 0."""
    return torch.gather(v, 0, y.reshape(1, -1).to(v.device).long())[0]


def wim_measures(cfg: CVNetConfig, losses: Dict[str, torch.Tensor],
                 methods: Sequence[str],
                 y_est: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """WIM score grammar k~ / k@ / k~@ (ref ft/wim.py:132-201).

    losses: per-class losses (C, N) and the '@' twins from the alternate
    prior; y_est: estimated labels (N,) (the kl-argmin pseudo-labels)."""
    losses = dict(losses)
    losses['elbo'] = -losses['total']
    if any('@' in m for m in methods):
        losses['elbo@'] = -losses['total@']

    per_class = cfg.losses_per_class
    out = {}
    for m in methods:
        base = m.rstrip('~@')
        soft = base.startswith('soft')
        k = base[4:] if soft else base
        sign = K_SIGN[k]
        signed = sign * losses[k]

        if m.endswith('~@'):
            assert y_est is not None
            out[m] = _take(signed, y_est) - sign * losses[k + '@']
        elif m.endswith('@'):
            if per_class and signed.ndim > 1:
                agg = torch.logsumexp(signed, dim=0)
            else:
                agg = signed
            out[m] = agg - sign * losses[k + '@']
        elif m.endswith('~'):
            assert y_est is not None
            v = torch.softmax(signed, dim=0) if soft else signed
            out[m] = _take(v, y_est)
        else:
            raise ValueError('not a wim method: {}'.format(m))
    return out


def is_wim_method(m: str) -> bool:
    return m[-1] in '~@'
