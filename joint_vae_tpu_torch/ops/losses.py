"""Reconstruction and classification loss primitives.

Port of ``joint_vae_tpu/ops/losses.py`` (behavioral spec: the reference
``module/losses.py``):

- ``mse_loss``: mean squared error over the trailing ``ndim`` image dims,
  the target broadcast over leading sampling/class axes;
- ``categorical_loss``: 256-way per-pixel cross entropy, target pixels
  quantized with ``floor(x * 255)``, summed over image dims;
- ``x_loss``: label cross entropy over a leading latent-sample axis L; with
  no label, the per-class negative log posterior, class axis moved first.

Reductions run in float32 whatever the input dtype.
"""

from typing import Optional

import torch


def _image_dims(x: torch.Tensor, ndim: int):
    return tuple(range(x.ndim - ndim, x.ndim))


def mse_loss(x_output: torch.Tensor, x_target: torch.Tensor, ndim: int = 3,
             batch_mean: bool = True,
             low_precision: bool = False) -> torch.Tensor:
    """x_target (N.., D..); x_output (L, [C,] N.., D..) -> (L, [C,] N..)
    per-sample MSE, or its scalar mean when ``batch_mean``.

    ``low_precision`` takes the difference and its square in x_output's
    dtype when that is not float32 (bfloat16 models) and only the mean in
    float32, as the JAX package's ``low_precision`` does."""
    if low_precision and x_output.dtype != torch.float32:
        diff = x_output - x_target.to(x_output.dtype)
        per = torch.mean(torch.square(diff).float(),
                         dim=_image_dims(diff, ndim))
        return torch.mean(per) if batch_mean else per
    diff = (x_output - x_target).float()
    per = torch.mean(torch.square(diff), dim=_image_dims(diff, ndim))
    return torch.mean(per) if batch_mean else per


def categorical_loss(x_output: torch.Tensor, x_target: torch.Tensor,
                     ndim: int = 3, batch_mean: bool = True) -> torch.Tensor:
    """x_output (..., 256, D..) logits; x_target (N.., D..) in [0, 1]
    -> per-item cross entropy summed over image dims."""
    labels = torch.clamp(torch.floor(x_target * 255.0), 0, 255).long()
    class_dim = x_output.ndim - ndim - 1
    logp = torch.log_softmax(x_output.float(), dim=class_dim)
    lead = logp.shape[:class_dim]
    labels_b = labels.expand(lead + labels.shape[-ndim:])
    ce = -torch.gather(logp, class_dim,
                       labels_b.unsqueeze(class_dim)).squeeze(class_dim)
    ce = torch.sum(ce.reshape(ce.shape[:-ndim] + (-1,)), dim=-1)
    return torch.mean(ce) if batch_mean else ce


def x_loss(y_target: Optional[torch.Tensor], logits: torch.Tensor,
           batch_mean: bool = True) -> torch.Tensor:
    """Label cross entropy; logits (L, N.., C).

    With labels: CE averaged over the sample axis (and the batch if
    ``batch_mean``).  Without: -log(softmax + 1e-6) averaged over samples
    1: when L > 1, class axis first -> (C, N..)."""
    logits = logits.float()
    if y_target is None:
        log_p = torch.log(torch.softmax(logits, dim=-1) + 1e-6)
        lp = -torch.mean(log_p[1:], dim=0) if logits.shape[0] > 1 else -log_p[0]
        return torch.movedim(lp, -1, 0)
    logp = torch.log_softmax(logits, dim=-1)
    y_b = y_target.long().expand(logp.shape[:-1])
    ce = -torch.gather(logp, -1, y_b.unsqueeze(-1))[..., 0]
    ce = torch.mean(ce, dim=0)      # over all L samples (incl. the mean one)
    return torch.mean(ce) if batch_mean else ce
