"""ODIN: input-gradient perturbation + temperature scaling.

Port of ``joint_vae_tpu/evals/odin.py`` (ref cvae.py:1646-1663).  Per
batch:

- one forward with x requiring a gradient gives the unscaled mean logits;
  each temperature's input gradient is one backward of that same graph
  (the logits do not depend on T), so the model runs forward once for all
  temperatures;
- the epsilon perturbations are batched into a single (E*N) forward per
  temperature, under ``torch.no_grad()``.

Scores: max softmax(mean-sample logits / T) on x + eps * sign(d score / dx)
(gradient ascent on the max-softmax, ref :1651-1662).  As in the JAX
package, every temperature uses its own clean gradient (the reference
accumulates them, a latent torch bug), so scores match the reference
exactly only for the first temperature of a grid.

The parameters take no gradient; on the card x's gradient runs the conv
kernel's dx (``ops/same_grid_conv.py::SameGridConvFn``) at every
same-grid site of the features, the first one (which reads x) included.
The latent noise comes from ``generator``, or from ``eps`` (L+1, N, K),
which the perturbed forward repeats for each epsilon.
"""

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch

from ..models.cvnet import CVNet, ODIN_EPS, ODIN_TEMPS
from ..ops.sampling import reparameterize


def odin_key(T: float, e: float) -> str:
    return 'odin-{:.0f}-{:.4f}'.format(T, e)


def mean_logits(model: CVNet, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the latent samples 1..L of the logits of the model's
    evaluation forward (features -> encode -> sample -> classify; the
    reconstruction does not enter the logits)."""
    cfg = model.cfg
    t = model.features(x)
    mu, log_var, _ = model.encode(t)
    dist = 'uniform' if cfg.prior.distribution == 'uniform' else 'gaussian'
    sampled = cfg.latent_sampling > 1 or cfg.beta > 0
    z, _ = reparameterize(mu, log_var, cfg.test_latent_sampling, dist,
                          sampled, eps=eps, generator=generator)
    logits = model.classify(z).float()
    return torch.mean(logits[1:], dim=0) if logits.shape[0] > 1 else logits[0]


@contextlib.contextmanager
def _no_param_grads(model: CVNet):
    """The parameters take no gradient inside (the conv's backward then
    skips its weight gradient); their flags are restored on exit."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def make_odin_scores(model: CVNet, temps: Sequence[float] = None,
                     eps_grid: Sequence[float] = None) -> Callable:
    """-> ``odin(x, generator=None, eps=None)`` returning
    {'odin-T-eps': (N,)} on x's device."""
    temps = list(temps if temps is not None else ODIN_TEMPS)
    eps_grid = list(eps_grid if eps_grid is not None else ODIN_EPS)
    if model.cfg.y_is_coded:
        raise ValueError('ODIN needs a model that does not code y')

    grids = {}      # the epsilon grid on each (device, dtype, ndim) met

    def odin(x: torch.Tensor, generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        n = x.shape[0]
        key = (x.device, x.dtype, x.ndim)
        if key not in grids:
            # made at the first call, outside any graph capture (a copy
            # from the host cannot be captured)
            grids[key] = torch.tensor(eps_grid, dtype=x.dtype,
                                      device=x.device).reshape(
                                          (-1,) + (1,) * x.ndim)
        e_grid = grids[key]
        eps_rep = None if eps is None else eps.repeat(1, len(eps_grid), 1)
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad(), _no_param_grads(model):
            ml = mean_logits(model, xg, generator, eps)
        out = {}
        for i, T in enumerate(temps):
            # d/dml sum_n max softmax(ml / T): the cotangent of this T
            with torch.enable_grad():
                mld = ml.detach().requires_grad_(True)
                s = torch.sum(torch.amax(torch.softmax(mld / T, dim=-1),
                                         dim=-1))
                cot, = torch.autograd.grad(s, mld)
                dx, = torch.autograd.grad(ml, xg, cot,
                                          retain_graph=i < len(temps) - 1)
            with torch.no_grad():
                xp = x[None] + e_grid * torch.sign(dx)[None]
                ml_p = mean_logits(model, xp.reshape((-1,) + x.shape[1:]),
                                   generator, eps_rep)
                sc = torch.amax(torch.softmax(ml_p / T, dim=-1), dim=-1)
            sc = sc.reshape(len(eps_grid), n)
            for j, e in enumerate(eps_grid):
                out[odin_key(T, e)] = sc[j]
        return out

    return odin
