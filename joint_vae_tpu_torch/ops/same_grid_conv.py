"""Same-grid NHWC convolution: the CUDA kernel's wrappers, their plain
PyTorch versions and the autograd Function that carries gradients through
them.

Port of ``joint_vae_tpu/ops/pallas_conv.py`` (``_same_grid_conv`` and its
``custom_vjp``): a stride-(1, 1) conv whose output grid equals its input
grid — pads ``(ph_lo, th-1-ph_lo)`` x ``(pw_lo, tw-1-pw_lo)``, possibly
asymmetric — on x (n, h, w, ci) with an HWIO kernel (th, tw, ci, co),
float32 accumulation, output in the input dtype, no bias.  The kernel is
``csrc/same_grid_conv.cu`` (tensor cores: 3xTF32 in float32, one bf16
pass in bfloat16); on a CUDA tensor a wrapper launches it or raises, and
only CPU tensors take the plain version.  The model calls it at its
same-grid (de)convs and at the packed conv of its sub-pixel deconvs
(``models/conv.py``), through :class:`SameGridConvFn`.

Gradients (the JAX package's ``_bwd`` leaves both to XLA's conv vjp):

- dx is itself a same-grid conv of the output gradient with the kernel
  flipped in both spatial axes and ci/co swapped, at pads
  ``(th-1-ph_lo, tw-1-pw_lo)``: :func:`same_grid_conv_dx` runs it on the
  same kernel (its own launch counter);
- dw, a per-tap reduction ``dw[a, b] = sum x_shift(a, b)^T g``, is
  :func:`same_grid_conv_dw`: float32 matrix products (cuBLAS) over an
  im2col copy of x, a chunk of images at a time; no hand-written kernel.
  cuDNN's float32 weight gradient (TF32 off) is not precise enough at the
  flagship's same-grid shapes on the H100: off by 3.3% of its rms at
  conv_2 and 1.3% at deconv_1 at batch 1024 (``chip_smoke.py`` prints
  its error beside the product's).
"""

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from . import cuda_lib

IM2COL_BYTES = 1 << 29        # the im2col copy of a chunk of images


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


def dx_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The kernel of the input gradient: flipped in (th, tw), ci and co
    swapped, contiguous HWIO (th, tw, co, ci)."""
    return kernel.flip(0, 1).transpose(2, 3).contiguous()


def same_grid_conv_dx_plain(g: torch.Tensor, kernel: torch.Tensor,
                            ph_lo: int, pw_lo: int) -> torch.Tensor:
    """dx of :func:`same_grid_conv_plain` for the output gradient g."""
    th, tw = kernel.shape[:2]
    return same_grid_conv_plain(g, dx_kernel(kernel), th - 1 - ph_lo,
                                tw - 1 - pw_lo)


def _im2col(xp: torch.Tensor, th: int, tw: int, h: int, w: int
            ) -> torch.Tensor:
    """(n * h * w, th * tw * ci) windows of the padded NHWC ``xp``, in
    (tap row, tap column, channel) order along a row (a copy)."""
    n, _, _, ci = xp.shape
    sn, sh, sw, sc = xp.stride()
    return xp.as_strided((n, h, w, th, tw, ci), (sn, sh, sw, sh, sw, sc),
                         xp.storage_offset()).reshape(n * h * w, th * tw * ci)


def same_grid_conv_dw(x: torch.Tensor, g: torch.Tensor, th: int, tw: int,
                      ph_lo: int, pw_lo: int) -> torch.Tensor:
    """dw (th, tw, ci, co) of the same-grid conv of x (n, h, w, ci) at pads
    (ph_lo, pw_lo) whose output gradient is g (n, h, w, co):
    im2col(x)^T g, summed over chunks of images in x's dtype."""
    n, h, w, ci = x.shape
    co = g.shape[3]
    xp = F.pad(x, (0, 0, pw_lo, tw - 1 - pw_lo, ph_lo, th - 1 - ph_lo))
    k = th * tw * ci
    chunk = max(1, IM2COL_BYTES // (h * w * k * x.element_size()))
    dw = torch.zeros((k, co), dtype=x.dtype, device=x.device)
    for i in range(0, n, chunk):
        cols = _im2col(xp[i:i + chunk], th, tw, h, w)
        dw.addmm_(cols.t(), g[i:i + chunk].reshape(-1, co))
    return dw.reshape(th, tw, ci, co)


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


def _run(x: torch.Tensor, kernel: torch.Tensor, ph_lo: int, pw_lo: int):
    """-> (y, launched): the plain version on CPU tensors, the kernel on
    CUDA tensors (or a raise)."""
    _check(x, kernel, ph_lo, pw_lo)
    if x.device.type == 'cpu' and kernel.device.type == 'cpu':
        return same_grid_conv_plain(x, kernel, ph_lo, pw_lo), False
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
        return y, False
    lib = cuda_lib.load('same_grid_conv')
    fn = (lib.same_grid_conv_f32 if x.dtype == torch.float32
          else lib.same_grid_conv_bf16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), kernel.data_ptr(), y.data_ptr(), n, h, w, ci, co,
            th, tw, ph_lo, pw_lo, stream)
    cuda_lib.check(lib, rc, 'same_grid_conv')
    return y, True


def same_grid_conv(x: torch.Tensor, kernel: torch.Tensor,
                   ph_lo: int, pw_lo: int) -> torch.Tensor:
    """y (n, h, w, co) = same-grid conv of x (n, h, w, ci) with the HWIO
    ``kernel``.  CPU tensors run :func:`same_grid_conv_plain`; CUDA tensors
    launch the kernel (float32 or bfloat16, contiguous) or raise."""
    y, launched = _run(x, kernel, ph_lo, pw_lo)
    same_grid_conv.launches += launched
    return y


def same_grid_conv_dx(g: torch.Tensor, kernel: torch.Tensor,
                      ph_lo: int, pw_lo: int) -> torch.Tensor:
    """dx (n, h, w, ci) of the same-grid conv at pads (ph_lo, pw_lo) for
    the output gradient g (n, h, w, co): the same kernel (or plain version)
    on :func:`dx_kernel`, counted in ``same_grid_conv_dx.launches``."""
    th, tw = kernel.shape[:2]
    y, launched = _run(g, dx_kernel(kernel), th - 1 - ph_lo, tw - 1 - pw_lo)
    same_grid_conv_dx.launches += launched
    return y


class SameGridConvFn(torch.autograd.Function):
    """y = same_grid_conv(x, kernel, ph_lo, pw_lo) with its gradients:
    dx on the kernel (:func:`same_grid_conv_dx`), dw as matrix products
    (:func:`same_grid_conv_dw`).  The backward's spans are labelled
    ``same_grid_conv_dx`` and ``same_grid_conv_dw`` for the profiler."""

    @staticmethod
    def forward(ctx, x, kernel, ph_lo: int, pw_lo: int):
        ctx.save_for_backward(x, kernel)
        ctx.pads = (ph_lo, pw_lo)
        return same_grid_conv(x, kernel, ph_lo, pw_lo)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        ph_lo, pw_lo = ctx.pads
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            with record_function('same_grid_conv_dx'):
                dx = same_grid_conv_dx(g, kernel, ph_lo, pw_lo)
        if ctx.needs_input_grad[1]:
            with record_function('same_grid_conv_dw'):
                dw = same_grid_conv_dw(x, g, kernel.shape[0], kernel.shape[1],
                                       ph_lo, pw_lo)
        return dx, dw, None, None


same_grid_conv.launches = 0
same_grid_conv_dx.launches = 0
