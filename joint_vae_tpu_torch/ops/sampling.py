"""Reparameterized latent sampling with the (L+1, eps0 = 0) convention.

Port of ``joint_vae_tpu/ops/sampling.py``: every forward draws L+1 samples
where sample 0 is the pass-through mean (epsilon = 0); epsilon is gaussian,
or uniform(+-sqrt(3)) for the uniform-tail prior.  The noise comes from an
explicit ``torch.Generator``, or is injected through ``eps`` (tests feed
the same numpy noise to the port and to the JAX package).
"""

from typing import Optional, Tuple

import torch

from ..parallel.mesh import draw_rows

SQRT12 = 3.4641016151377544  # sqrt(12)


def draw_epsilon(shape: Tuple[int, ...], sampling_size: int,
                 distribution: str = 'gaussian', *,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """(L+1, *shape) noise with eps[0] = 0; on a mesh, this rank's rows
    (axis -2) of the global batch's draw (``parallel/mesh.py::draw_rows``)."""
    full = (sampling_size + 1,) + tuple(shape)
    if distribution == 'gaussian':
        eps = draw_rows(lambda s: torch.randn(s, generator=generator,
                                              device=device, dtype=dtype),
                        full)
    elif distribution == 'uniform':
        eps = (draw_rows(lambda s: torch.rand(s, generator=generator,
                                              device=device, dtype=dtype),
                         full) - 0.5) * SQRT12
    else:
        raise ValueError('{} for sampling unknown'.format(distribution))
    eps[0] = 0.0
    return eps


def reparameterize(z_mean: torch.Tensor, z_log_var: torch.Tensor,
                   sampling_size: int, distribution: str = 'gaussian',
                   is_sampled: bool = True, *,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z = mu + exp(log_var / 2) * eps with eps (L+1, ...), eps[0] = 0.

    Returns (z, eps[1:]).  ``eps`` (L+1, *mu.shape) replaces the draw; its
    row 0 is used as given (callers pass zeros there).  ``is_sampled=False``
    collapses every sample to the mean."""
    if eps is None:
        eps = draw_epsilon(z_mean.shape, sampling_size, distribution,
                           generator=generator, device=z_mean.device,
                           dtype=z_mean.dtype)
    else:
        expect = (sampling_size + 1,) + tuple(z_mean.shape)
        if tuple(eps.shape) != expect:
            raise ValueError('eps has shape {}, expected {}'.format(
                tuple(eps.shape), expect))
        eps = eps.to(device=z_mean.device, dtype=z_mean.dtype)
    scale = torch.exp(0.5 * z_log_var) * float(is_sampled)
    z = z_mean[None] + scale[None] * eps
    return z, eps[1:]
