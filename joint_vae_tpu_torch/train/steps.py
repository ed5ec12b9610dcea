"""Train and eval steps.

Port of ``joint_vae_tpu/train/steps.py``: the hot loop of ref
``train_model`` (cvae.py:2424-2479) as one eager step — evaluate in
training mode -> grad -> grad mask -> clip + optimizer -> update mask ->
apply — with the warmup ramps computed from the epoch counter.  Nothing
in the step waits for the card: the metrics stay device scalars until the
caller pulls them.
"""

from typing import Callable, Optional, Tuple

import torch

from ..models.conv import apply_bn_updates
from ..models.cvnet import CVNet
from ..models.evaluate import evaluate
from .optimizers import OptimizerConfig, build_optimizer, global_norm
from .state import TrainState, apply_grad_mask, grad_mask, named_params


def warmup_weight(epoch: int, warmup: Tuple[int, int]) -> float:
    """clip((epoch + 1 - start) / (length + 1), 0, 1) — ref cvae.py:2432."""
    return min(max((epoch + 1.0 - warmup[0]) / (warmup[1] + 1.0), 0.0), 1.0)


def make_train_step(model: CVNet, opt_cfg: OptimizerConfig,
                    warmup: Tuple[int, int] = (0, 0),
                    warmup_gamma: Tuple[int, int] = (0, 0),
                    frozen_modules: Tuple[str, ...] = ()) -> Callable:
    """The train step: ``step(state, x, y, eps=None) -> (state, metrics)``.

    x (N, *input_shape) and y (N,) on the model's device.  ``eps``
    (L+1, N, K) injects the latent noise (tests); otherwise it is drawn
    from ``state.generator``, as are the dropout masks.  The model's
    parameters and BatchNorm buffers and ``state`` are updated in place.
    metrics: 0-dim device tensors — the batch mean of each loss, the
    measures, ``grad_norm`` (of the masked gradient) and ``train_acc``
    when the model classifies."""
    cfg = model.cfg
    has_bn = cfg.has_batch_norm
    tx = build_optimizer(opt_cfg)
    mask = grad_mask(model, frozen_modules)
    params = named_params(model)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             eps: Optional[torch.Tensor] = None):
        kl_w = warmup_weight(state.epoch, warmup)
        g_w = warmup_weight(state.epoch, warmup_gamma)
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
        grads = apply_grad_mask(model, grads, mask, state.epoch)
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        # frozen parameters receive no update at all (weight decay inside
        # the optimizer would otherwise still move them)
        updates = apply_grad_mask(model, updates, mask, state.epoch)
        with torch.no_grad():
            torch._foreach_add_([params[k] for k in names],
                                [updates[k] for k in names])
        if bn_updates:
            apply_bn_updates(bn_updates)
        state.sigma_state = out.sigma_state
        state.step += 1

        metrics = {k: torch.mean(v.detach()) for k, v in out.losses.items()}
        metrics.update({k: v.detach() for k, v in out.measures.items()})
        metrics['grad_norm'] = global_norm(list(grads.values()))
        if cfg.y_is_decoded:
            # running train accuracy from the sample-mean logits
            metrics['train_acc'] = torch.mean(
                (torch.argmax(out.logits.detach(), dim=-1) == y).float())
        return state, metrics

    return step


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
    """Device metric dicts -> host float dicts, in one transfer."""
    if not pending:
        return []
    keys = list(pending[0])
    flat = torch.stack([torch.stack([m[k].float().reshape(()) for k in keys])
                        for m in pending]).cpu().tolist()
    return [dict(zip(keys, row)) for row in flat]

