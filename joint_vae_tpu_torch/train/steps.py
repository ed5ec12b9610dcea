"""Train and eval steps.

Port of ``joint_vae_tpu/train/steps.py``: the hot loop of ref
``train_model`` (cvae.py:2424-2479) as one step — evaluate in training
mode -> grad -> grad mask -> clip + optimizer -> update mask -> apply —
with the warmup ramps computed from the epoch counter.  On the card the
step is a CUDA graph (``train/graphs.py``), the counterpart of JAX's
``jax.jit`` of it: its body updates the parameters, the moments, the
sigma state and BatchNorm's statistics in place, reads the warmup ramps,
the prior-mean thaw, the learning rate and Adam's count from device
scalars set outside it, and packs its metrics into one vector; the host
counts advance once per real step, outside it.  Nothing in the step waits
for the card: the metrics stay on the card until the caller pulls them.
"""

from typing import Callable, Optional, Tuple

import torch

from ..device import module_device
from ..models.conv import apply_bn_updates
from ..models.cvnet import CVNet
from ..models.evaluate import evaluate
from ..ops.sigma import SigmaState
from ..parallel.mesh import Mesh, mesh_scope, split_names
from ..parallel.shard_steps import global_grad_norm, reduce_step
from .graphs import PackedMetrics, Rows, StepGraph, graph_mode
from .optimizers import (OptimizerConfig, advance_counts, build_optimizer,
                         sync_device_scalars)
from .state import (TrainState, apply_grad_mask, grad_mask, named_params,
                    thaw_factor)


def warmup_weight(epoch: int, warmup: Tuple[int, int]) -> float:
    """clip((epoch + 1 - start) / (length + 1), 0, 1) — ref cvae.py:2432."""
    return min(max((epoch + 1.0 - warmup[0]) / (warmup[1] + 1.0), 0.0), 1.0)


def copy_sigma_state(dst: SigmaState, src: SigmaState) -> None:
    """The step's new sigma state into the state's own buffers, in place
    (a replay keeps writing where the capture wrote)."""
    with torch.no_grad():
        if src.data is not dst.data:
            dst.data.copy_(src.data)
        if src.rmse is not dst.rmse:
            dst.rmse.copy_(src.rmse)


def as_input(x: torch.Tensor) -> torch.Tensor:
    """A batch as the model takes it: uint8 images (a set held on the card)
    become float32 as ``x * float32(1/255)`` (torch takes the Python scalar
    in the tensor's float32, as JAX takes its weakly typed one)."""
    return x.float() * (1.0 / 255.0) if x.dtype == torch.uint8 else x


class TrainStep:
    """The train step: ``step(state, x, y, eps=None) -> (state, metrics)``
    (see :func:`make_train_step`); :meth:`gather` feeds it rows of a set
    held on the card."""

    def __init__(self, model: CVNet, opt_cfg: OptimizerConfig,
                 warmup=(0, 0), warmup_gamma=(0, 0), frozen_modules=(),
                 mesh: Optional[Mesh] = None,
                 split_sampling_per_shard: bool = True,
                 graphed: Optional[bool] = None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.warmup = tuple(warmup)
        self.warmup_gamma = tuple(warmup_gamma)
        self.mesh = mesh
        self.same_noise = not split_sampling_per_shard
        self.tx = build_optimizer(opt_cfg)
        self.mask = grad_mask(model, frozen_modules)
        self.params = named_params(model)
        self.split = split_names(model)
        self.freezes = thaw_factor(model, 0) is not None
        self._epoch = None          # the epoch the ramps were set for
        self._ramps = None          # device scalars: kl_w, g_w, thaw
        self.graph = StepGraph(self._body, name='train_step',
                               graphed=graph_mode(graphed, mesh))

    def _set_ramps(self, state: TrainState) -> None:
        """The epoch's ramps (float64, as the host computes them: their
        products with float32 tensors round as a Python float's do) and
        thaw (float32) into their device scalars, filled when the epoch
        moves."""
        dev = module_device(self.model)
        if self._ramps is None or self._ramps[0].device != dev:
            self._ramps = tuple(torch.zeros((), dtype=dt, device=dev)
                                for dt in (torch.float64, torch.float64,
                                           torch.float32))
            self._epoch = None
        if state.epoch != self._epoch:
            e = state.epoch
            vals = (warmup_weight(e, self.warmup),
                    warmup_weight(e, self.warmup_gamma),
                    thaw_factor(self.model, e) or 0.0)
            for t, v in zip(self._ramps, vals):
                t.fill_(v)
            self._epoch = e

    def _body(self, state: TrainState, x: torch.Tensor, y: torch.Tensor,
              eps: Optional[torch.Tensor] = None) -> dict:
        model, params, cfg = self.model, self.params, self.model.cfg
        mesh = self.mesh
        has_bn = cfg.has_batch_norm
        kl_w, g_w, thaw = self._ramps
        thaw = thaw if self.freezes else None
        x = as_input(x)
        with mesh_scope(mesh, rows=True, same_noise=self.same_noise):
            res = evaluate(model, x, y, sigma_state=state.sigma_state,
                           train=True, with_beta=True, kl_var_weighting=kl_w,
                           gamma_weighting=g_w, return_bn_updates=has_bn,
                           native_scores=True, eps=eps,
                           generator=state.generator)
            out, bn_updates = res if has_bn else (res, None)
            loss = torch.mean(out.losses['total'])
            names = list(params)
            got = torch.autograd.grad(loss, [params[k] for k in names],
                                      allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, got)}
        metrics = {k: torch.mean(v.detach()) for k, v in out.losses.items()}
        metrics.update({k: v.detach() for k, v in out.measures.items()})
        if cfg.y_is_decoded:
            # running train accuracy from the sample-mean logits
            metrics['train_acc'] = torch.mean(
                (torch.argmax(out.logits.detach(), dim=-1) == y).float())
        sigma_state = out.sigma_state
        if mesh is not None:
            grads, metrics, sigma_state = reduce_step(
                cfg, mesh, grads, metrics, sigma_state, state.sigma_state,
                out.measures.get('mse'))
        grads = apply_grad_mask(model, grads, self.mask, state.epoch, thaw)
        norm = global_grad_norm(grads, mesh, self.split)
        updates, state.opt_state = self.tx.update(
            grads, state.opt_state, params, norm=norm, capturable=True)
        # frozen parameters receive no update at all (weight decay inside
        # the optimizer would otherwise still move them)
        updates = apply_grad_mask(model, updates, self.mask, state.epoch,
                                  thaw)
        with torch.no_grad():
            torch._foreach_add_([params[k] for k in names],
                                [updates[k] for k in names])
        if bn_updates:
            apply_bn_updates(bn_updates)
        copy_sigma_state(state.sigma_state, sigma_state)
        metrics['grad_norm'] = norm
        return metrics

    def _run(self, state: TrainState, **inputs) -> Tuple[TrainState,
                                                        PackedMetrics]:
        self._set_ramps(state)
        sync_device_scalars(state.opt_state, module_device(self.model))
        metrics = self.graph(state, **inputs)
        advance_counts(state.opt_state, self.opt_cfg.optim_type == 'adam')
        state.step += 1
        return state, metrics

    def __call__(self, state: TrainState, x: torch.Tensor, y: torch.Tensor,
                 eps: Optional[torch.Tensor] = None):
        return self._run(state, x=x, y=y, eps=eps)

    def gather(self, state: TrainState, data_x: torch.Tensor,
               data_y: torch.Tensor, rows, eps: Optional[torch.Tensor] = None):
        """The step on rows ``rows`` (an index tensor or a slice) of arrays
        on the card, gathered straight into the step's input buffers."""
        return self._run(state, x=Rows(data_x, rows), y=Rows(data_y, rows),
                         eps=eps)


def make_train_step(model: CVNet, opt_cfg: OptimizerConfig,
                    warmup: Tuple[int, int] = (0, 0),
                    warmup_gamma: Tuple[int, int] = (0, 0),
                    frozen_modules: Tuple[str, ...] = (),
                    mesh: Optional[Mesh] = None,
                    split_sampling_per_shard: bool = True,
                    graphed: Optional[bool] = None) -> Callable:
    """The train step: ``step(state, x, y, eps=None) -> (state, metrics)``.

    x (N, *input_shape) and y (N,) on the model's device.  ``eps``
    (L+1, N, K) injects the latent noise (tests); otherwise it is drawn
    from ``state.generator``, as are the dropout masks.  The model's
    parameters and BatchNorm buffers and ``state`` are updated in place.
    metrics: 0-dim device tensors — the batch mean of each loss, the
    measures, ``grad_norm`` (of the masked gradient) and ``train_acc``
    when the model classifies — views of one packed float32 vector.

    ``graphed`` (default: True, but on a mesh over gloo on a card:
    ``graphs.py::graph_mode``) replays the step as a CUDA graph on the
    card (``train/graphs.py``; its first step eager, the second captured,
    a mesh step's collectives inside it); False runs it eagerly.  The
    same body runs either way, and on the CPU on the graph's static
    buffers.

    On a ``mesh`` (the state placed there, ``mesh.py::ensure_placed``)
    x and y are this rank's rows of the global batch and the step is the
    global batch's (``parallel/shard_steps.py``): one all-reduce over
    'data', the sigma state rebuilt from the global mse, the clipping
    norm summed over 'model'.  ``split_sampling_per_shard=False`` draws
    the local noise shape, the same on every rank."""
    return TrainStep(model, opt_cfg, warmup, warmup_gamma, frozen_modules,
                     mesh, split_sampling_per_shard, graphed)


def make_eval_step(model: CVNet, with_labels: bool, L: Optional[int] = None,
                   iws: bool = True) -> Callable:
    """Evaluation step returning the per-item loss dict plus logits, mu and
    log-var (ref cvae.py:1316-1330, 1620-1700):
    ``step(sigma_state, x, y, generator=None, eps=None)``."""

    def step(sigma_state, x, y, generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None):
        out = evaluate(model, x, y if with_labels else None,
                       sigma_state=sigma_state, train=False, L=L,
                       compute_iws=iws, eps=eps, generator=generator)
        return out.losses, out.logits, out.mu, out.log_var

    return step


def pull_metrics(pending) -> list:
    """Device metric dicts (a step's :class:`PackedMetrics` as its packed
    vector) -> host float dicts, in one transfer."""
    if not pending:
        return []
    keys = list(pending[0])
    flat = torch.stack([
        m.vector if isinstance(m, PackedMetrics) and list(m) == keys
        else torch.stack([m[k].float().reshape(()) for k in keys])
        for m in pending]).cpu().tolist()
    return [dict(zip(keys, row)) for row in flat]

