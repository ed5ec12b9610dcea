"""Per-class IWAE combine: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of ``joint_vae_tpu/ops/pallas_kernels.py`` (``iws_fused``).  For a
class-conditional gaussian prior with scalar variance,

    log w[l, c, n] = log_pxq[l, n] + const_c - 0.5 * s2_c * ||z[l,n] - m_c||^2
    const_c = -0.5 * K * log(2 pi) - 0.5 * log_det_prior_c

and iws[c, n] reduces over l: log-mean-exp, or with ``ref_mode`` the
reference's published mean-exp + max (cvae.py:870).  The kernel is
``csrc/iws_combine.cu``; on CUDA tensors the wrapper launches it or
raises, and only CPU tensors take the plain version.
"""

import math

import torch

from . import cuda_lib

_LOG_2PI = math.log(2 * math.pi)


def iws_log_weights(z: torch.Tensor, log_pxq: torch.Tensor,
                    mean: torch.Tensor, s2: torch.Tensor,
                    log_det_prior: torch.Tensor) -> torch.Tensor:
    """The materialized log w (L, C, N)."""
    L, N, K = z.shape
    C = mean.shape[0]
    diff = z[:, None] - mean[None, :, None]                  # (L, C, N, K)
    mahala = torch.sum(torch.square(diff), dim=-1) * s2.reshape(1, C, 1)
    const = (-0.5 * K * _LOG_2PI - 0.5 * log_det_prior).reshape(1, C, 1)
    return log_pxq[:, None] + const - 0.5 * mahala


def iws_combine_plain(z: torch.Tensor, log_pxq: torch.Tensor,
                      mean: torch.Tensor, s2: torch.Tensor,
                      log_det_prior: torch.Tensor,
                      ref_mode: bool = True) -> torch.Tensor:
    """The materialized (L, C, N) combine."""
    logw = iws_log_weights(z, log_pxq, mean, s2, log_det_prior)
    m = torch.amax(logw, dim=0)
    d = torch.exp(logw - m[None])
    return (torch.mean(d, dim=0) + m) if ref_mode \
        else torch.log(torch.mean(d, dim=0)) + m


def iws_combine(z: torch.Tensor, log_pxq: torch.Tensor, mean: torch.Tensor,
                s2: torch.Tensor, log_det_prior: torch.Tensor,
                ref_mode: bool = True) -> torch.Tensor:
    """iws (C, N) from z (L, N, K), log_pxq (L, N) [= log p(x|z) +
    log 1/q], prior means (C, K), inverse variances s2 (C,) and
    log_det_prior (C,), all float32."""
    args = (z, log_pxq, mean, s2, log_det_prior)
    if z.ndim != 3 or mean.ndim != 2:
        raise ValueError('iws_combine wants z (L,N,K) and mean (C,K)')
    L, N, K = z.shape
    C = mean.shape[0]
    shapes = [(L, N, K), (L, N), (C, K), (C,), (C,)]
    if [tuple(a.shape) for a in args] != shapes or mean.shape[1] != K:
        raise ValueError('iws_combine shapes {} != {}'.format(
            [tuple(a.shape) for a in args], shapes))
    if all(a.device.type == 'cpu' for a in args):
        return iws_combine_plain(*args, ref_mode=ref_mode)
    if not all(a.is_cuda and a.device == z.device for a in args):
        raise ValueError('iws_combine: inputs on several devices')
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError('iws_combine takes float32 inputs')
    if not all(a.is_contiguous() for a in args):
        raise ValueError('iws_combine needs contiguous inputs')
    if z.numel() >= 2 ** 31 or C * N >= 2 ** 31:
        raise ValueError('iws_combine: tensor too large for int32 shapes')
    out = torch.empty((C, N), dtype=torch.float32, device=z.device)
    lib = cuda_lib.load('iws_combine')
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with cuda_lib.launch_span('iws_combine'):
        rc = lib.iws_combine_f32(*(a.data_ptr() for a in args),
                                 out.data_ptr(), L, N, K, C,
                                 int(bool(ref_mode)), stream)
    cuda_lib.check(lib, rc, 'iws_combine')
    iws_combine.launches += 1
    return out


iws_combine.launches = 0


def kernel_splits(L: int, N: int, K: int, C: int) -> int:
    """How many blocks of a cluster the kernel splits l across at this
    shape on the current card (one launch whatever the split)."""
    rc = cuda_lib.load('iws_combine').iws_combine_splits(L, N, K, C)
    if rc < 0:
        raise RuntimeError('iws_combine_splits: cudaError {}'.format(-rc))
    return rc
