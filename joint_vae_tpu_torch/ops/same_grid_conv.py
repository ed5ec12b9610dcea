"""Same-grid NHWC convolution: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``joint_vae_tpu/ops/pallas_conv.py`` (``_same_grid_conv``): a
stride-(1, 1) conv whose output grid equals its input grid — pads
``(ph_lo, th-1-ph_lo)`` x ``(pw_lo, tw-1-pw_lo)``, possibly asymmetric —
on x (n, h, w, ci) with an HWIO kernel (th, tw, ci, co), float32
accumulation, output in the input dtype, no bias.  The kernel is
``csrc/same_grid_conv.cu`` (tensor cores: 3xTF32 in float32, one bf16
pass in bfloat16); on a CUDA tensor the wrapper launches it or raises,
and only CPU tensors take the plain version.  The model calls it at its
same-grid (de)convs and at the packed conv of its sub-pixel deconvs
(``models/conv.py``).
"""

import torch
import torch.nn.functional as F

from . import cuda_lib


def same_grid_conv_plain(x: torch.Tensor, kernel: torch.Tensor,
                         ph_lo: int, pw_lo: int) -> torch.Tensor:
    """Tap-by-tap shifted matmul sum (the kernel's arithmetic, in float32)."""
    n, h, w, ci = x.shape
    th, tw, _, co = kernel.shape
    xp = F.pad(x.float(), (0, 0, pw_lo, tw - 1 - pw_lo, ph_lo, th - 1 - ph_lo))
    kf = kernel.float()
    acc = torch.zeros((n, h, w, co), dtype=torch.float32, device=x.device)
    for a in range(th):
        for b in range(tw):
            acc += torch.matmul(xp[:, a:a + h, b:b + w, :], kf[a, b])
    return acc.to(x.dtype)


def _check(x: torch.Tensor, kernel: torch.Tensor, ph_lo: int, pw_lo: int):
    if x.ndim != 4 or kernel.ndim != 4:
        raise ValueError('same_grid_conv wants x (n,h,w,ci) and kernel '
                         '(th,tw,ci,co); got {} and {}'.format(
                             tuple(x.shape), tuple(kernel.shape)))
    if kernel.shape[2] != x.shape[3]:
        raise ValueError('kernel takes {} input channels, x has {}'.format(
            kernel.shape[2], x.shape[3]))
    th, tw = kernel.shape[:2]
    if not (0 <= ph_lo < th and 0 <= pw_lo < tw):
        raise ValueError('pads ({}, {}) do not keep the {}x{} grid'.format(
            ph_lo, pw_lo, th, tw))


def same_grid_conv(x: torch.Tensor, kernel: torch.Tensor,
                   ph_lo: int, pw_lo: int) -> torch.Tensor:
    """y (n, h, w, co) = same-grid conv of x (n, h, w, ci) with the HWIO
    ``kernel``.  CPU tensors run :func:`same_grid_conv_plain`; CUDA tensors
    launch the kernel (float32 or bfloat16, contiguous) or raise."""
    _check(x, kernel, ph_lo, pw_lo)
    if x.device.type == 'cpu' and kernel.device.type == 'cpu':
        return same_grid_conv_plain(x, kernel, ph_lo, pw_lo)
    if not (x.is_cuda and kernel.device == x.device):
        raise ValueError('same_grid_conv: x on {} and kernel on {}'.format(
            x.device, kernel.device))
    if x.dtype not in (torch.float32, torch.bfloat16) or kernel.dtype != x.dtype:
        raise TypeError('same_grid_conv takes float32 or bfloat16 x and '
                        'kernel of one dtype, got {} and {}'.format(
                            x.dtype, kernel.dtype))
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError('same_grid_conv needs contiguous NHWC x and HWIO '
                         'kernel')
    n, h, w, ci = x.shape
    th, tw, _, co = kernel.shape
    if max(x.numel(), n * h * w * co) >= 2 ** 31:
        raise ValueError('same_grid_conv: tensor too large for int32 shapes')
    y = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = cuda_lib.load('same_grid_conv')
    fn = (lib.same_grid_conv_f32 if x.dtype == torch.float32
          else lib.same_grid_conv_bf16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), kernel.data_ptr(), y.data_ptr(), n, h, w, ci, co,
            th, tw, ph_lo, pw_lo, stream)
    cuda_lib.check(lib, rc, 'same_grid_conv')
    same_grid_conv.launches += 1
    return y


same_grid_conv.launches = 0
