"""The data-parallel step's collectives over the mesh.

Port of ``joint_vae_tpu/parallel/shard_steps.py``.  The train step itself
is ``train/steps.py::make_train_step``, which takes a ``mesh``: each rank
runs the forward and backward of its rows of the global batch, then
:func:`reduce_step` averages the gradients over the 'data' group in one
flattened ``all_reduce``, together with the batch means of the losses and
measures and the sigma statistics, so that the update, the metrics and
the sigma state are the global batch's.  Every rank then applies the same
update to its replicated parameters and to its block of the class-split
ones.  WIM's fine-tune step (``ft/wim.py``) runs the same reduction.

- Class-split parameters ('model' axis) are gathered where they are read,
  with a backward that keeps this rank's block, so the ranks of a model
  group compute the same loss and each its block's gradient.  The global
  gradient norm (clipping and the ``grad_norm`` metric) sums the squares
  of those blocks over the 'model' group: a second collective, only when
  the model axis is split.
- Sigma: the rmse tracking is rebuilt from the global batch's mse (a
  coded sigma from the global mean of its head), as the one-process step
  computes it.
- BatchNorm in training normalises with the global batch's statistics
  (``mesh.py::batch_moments``), so BatchNorm trunks step as in one
  process.
- Noise: ``split_sampling_per_shard=True`` (the default) gives each shard
  its own noise as its rows of the global batch's draw, from the same
  generator state on every rank: the one-process run's noise.  ``False``
  draws the local shape, the same numbers on every shard.
"""

from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.sigma import SigmaState, sigma_value, update_sigma_rmse
from ..train.optimizers import OptimizerConfig, global_norm
from .mesh import Mesh, all_reduce_mean_


def reduce_over_data(tensors: Dict[str, torch.Tensor], mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """The mean over the 'data' group of every tensor of the dict, in one
    flattened ``all_reduce`` (run even on a group of one rank, so that a
    one-rank mesh over a backend runs the step's collective).  Each
    result is a tensor of its own: the optimizer's fused kernels take
    another path on a view at an unaligned offset of the buffer, and
    round otherwise than on the one-process run's gradients."""
    names = list(tensors)
    flat = torch.cat([tensors[k].detach().float().reshape(-1)
                      for k in names])
    all_reduce_mean_(flat, mesh, 'data', force=True)
    out, at = {}, 0
    for k in names:
        t = tensors[k]
        out[k] = flat[at:at + t.numel()].reshape(t.shape).to(t.dtype,
                                                            copy=True)
        at += t.numel()
    return out


def reduce_step(cfg, mesh: Mesh, grads: Dict[str, torch.Tensor],
                metrics: Dict[str, torch.Tensor], sigma_state: SigmaState,
                prev_sigma: SigmaState, mse: Optional[torch.Tensor]):
    """The global batch's (grads, metrics, sigma state) from this rank's,
    in one :func:`reduce_over_data`.  ``sigma_state`` is the one the
    local forward left, ``prev_sigma`` the step's input and ``mse`` the
    local batch's mse (when the model generates x): a coded sigma takes
    the global mean of its head, any other moves from ``prev_sigma`` by
    the global batch's rmse; a ``sigma`` metric then reports the rebuilt
    state (unless sigma is a learned parameter)."""
    scfg = cfg.sigma_cfg
    coded = cfg.x_is_generated and scfg.coded
    local = {**{'g/' + k: g for k, g in grads.items()},
             **{'m/' + k: v for k, v in metrics.items()}}
    if cfg.x_is_generated:
        local['mse'] = mse
        if coded:
            local['sigma'] = sigma_state.data
    red = reduce_over_data(local, mesh)
    grads = {k: red['g/' + k] for k in grads}
    metrics = {k: red['m/' + k] for k in metrics}
    if cfg.x_is_generated:
        sigma_state = (SigmaState(data=red['sigma'], rmse=sigma_state.rmse)
                       if coded else update_sigma_rmse(
                           scfg, prev_sigma,
                           torch.sqrt(torch.clamp(red['mse'], min=0.0))))
    learned = cfg.x_is_generated and scfg.learned and not scfg.coded
    if 'sigma' in metrics and not learned:
        metrics['sigma'] = sigma_value(scfg, sigma_state)
    return grads, metrics, sigma_state


def global_grad_norm(grads: Dict[str, torch.Tensor], mesh: Optional[Mesh],
                     split: set) -> torch.Tensor:
    """The norm of the whole gradient: the class-split blocks' squares are
    summed over the 'model' group (a plain ``global_norm`` without a mesh
    or blocks)."""
    blk = [g for k, g in grads.items() if k in split]
    if mesh is None or not blk or mesh.axis_size('model') == 1:
        return global_norm(list(grads.values()))
    rep = [g for k, g in grads.items() if k not in split]
    s_blk = torch.square(global_norm(blk))
    torch.distributed.all_reduce(s_blk, group=mesh.group('model'))
    s_rep = torch.square(global_norm(rep)) if rep else torch.zeros_like(s_blk)
    return torch.sqrt(s_rep + s_blk)


def make_shard_map_train_step(model, opt_cfg: OptimizerConfig, mesh: Mesh,
                              warmup: Tuple[int, int] = (0, 0),
                              warmup_gamma: Tuple[int, int] = (0, 0),
                              frozen_modules: Tuple[str, ...] = (),
                              split_sampling_per_shard: bool = True
                              ) -> Callable:
    """JAX's name for ``make_train_step(..., mesh=mesh)``: the step on
    this rank's rows of the global batch, the state placed on ``mesh``
    (``mesh.py::ensure_placed``)."""
    from ..train.steps import make_train_step
    return make_train_step(model, opt_cfg, warmup, warmup_gamma,
                           frozen_modules, mesh=mesh,
                           split_sampling_per_shard=split_sampling_per_shard)
