"""Conv/deconv stacks built from the reference's string DSL.

Port of ``joint_vae_tpu/models/conv.py`` (grammar: ref
module/vae_layers/conv.py:20-105 and conv-models.ini):

- layers separated by ``-``; a leading ``[...]`` block sets per-type defaults
- conv token ``CxK+P:S``: C out-channels, K kernel, P padding, S stride
- ``M.../A...``: max/avg pooling; ``U:S`` nearest upsampling by S
- deconv tokens also take ``++P`` output padding; ``!Cx..`` embeds a plain
  conv inside a deconv (upsampler) stack
- padding ``*`` means 'same' (K//2) for input-side convs, 0 otherwise
- named stacks (vgg*, conv32, deconv32, ivgg...) resolve to strings

:class:`ConvStack` keeps the (..., C, H, W) interface and computes NHWC.
The (de)convs follow the JAX package's lowerings (``conv_route``): every
stride-1 conv or deconv whose output grid equals its input grid, and every
stride-s deconv whose sub-pixel form keeps the grid, runs through
:class:`ops.same_grid_conv.SameGridConvFn` (the CUDA kernel on the card,
forward and input gradient); the 1x1 latent expansion is one
``torch.matmul``.  The rest is PyTorch, gradients included: strided convs
and stride-1 convs that change the grid (``F.conv2d``), the other strided
deconvs (``F.conv_transpose2d``), pooling, upsampling and BatchNorm (flax
semantics in both modes).  The JAX package's TPU-only lowerings (the
phase-packed decoder whose packing persists through later layers, the
grouped and c0-packed first conv) are not ported.
Parameters keep the JAX tree names (``conv_3``, ``deconv_1``, ``bn_2``) and
each layer stores its kernel in the layout its op takes
(``save_load/from_jax.py`` converts).
"""

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.same_grid_conv import SameGridConvFn

FEATURES_ARCHS = {
    'vgg11': '[x3-Mx2]64-M-128-M-256-256-M-512-512-M-512-512-M-Ax1',
    'vgg11-a': '[x3-Ax2]64-A-128-A-256-256-A-512-512-A-512-512-A-Ax1',
    'vgg13': '[x3-Mx2]64-64-M-128-128-M-256-256-M-512-512-M-512-512-M-Ax1',
    'vgg16': ('[x3-Mx2]64-64-M-128-128-M-256-256-256-M-512-512-512-M-'
              '512-512-512-M-Ax1'),
    'vgg19': ('[x3-Mx2]64-64-M-128-128-M-256-256-256-256-M-512-512-512-512-M-'
              '512-512-512-512-M-Ax1'),
    'vgg19-a': ('[x3-Ax2]64-64-A-128-128-A-256-256-256-256-A-512-512-512-512-A-'
                '512-512-512-512-A-Ax1'),
    'conv32': '[x5+2]32-32:2-64-64:2-200x7+0',
    'conv32-': '[x3+1]32-32-32-32:2-64-64-64-64:2-200x7+0',
    'conv32+': '[x5+2]32-32:2-64-64:2-128-128:2-200x3+0',
}

UPSAMPLER_ARCHS = {
    'deconv32': '[x5+2]64x8+0-64-64:2++1-32-32:2++1-32-!3x5+2',
    'deconv32-': '[x3+1]64x8+0-64-64-64-64:2++1-32-32-32-32:2++1-32-!3x5+2',
    'deconv32+': '[x5+2]128x4+0-128-128:2++1-64-64:2++1-32-32:2++1-32-!3x5+2',
    'ivgg': '[!x3+1-U:2]U-!128-U-!64-U-!32-U-!3',
    'ivgg19': ('[!x3+1-U:2]U-!512-!512-!512-!512-U-!512-!512-!512-!512-U-'
               '!256-!256-!256-!256-U-!128-!128-U-!64-!64-!3'),
    'ivgg11': '[!x3+1-U:2]U-!512-!512-U-!512-!512-U-!256-!256-U-!128-U-!64-!3',
}

# One left-to-right field scan over a layer token: a marked field ('++O'
# output padding, 'xK' kernel, '+P' padding, ':S' stride, '^C' channels,
# '!C' plain-conv-in-deconv) or a bare digit run (channels when it opens
# the token).  '*' or an empty value keeps the running default.
_FIELD_RX = re.compile(r'(\+\+|[x^+:!])([\d*]*)|(\d+)')
_FIELD_OF = {'x': 'kernel_size', '^': 'out_channels', '+': 'padding',
             ':': 'stride', '++': 'output_padding', '!': 'conv_in_deconv'}
_PREFIX_LTYPE = {'a': 'apooling', 'm': 'mpooling', 'u': 'upsampler'}


def parse_conv_layer_name(s: str, ltype: str = 'conv', out_channels: int = 32,
                          kernel_size: int = 5, padding='*', stride=None,
                          output_padding: int = 0, where: str = 'input') -> dict:
    """Parse one layer token of the conv-string DSL."""
    if where == 'output':
        ltype = 'deconv'
    if s[:1].lower() in _PREFIX_LTYPE:
        ltype = _PREFIX_LTYPE[s[0].lower()]
        s = s[1:]

    fields = {}
    for m in _FIELD_RX.finditer(s):
        if m.group(3) is not None:
            if m.start() == 0:              # leading bare int = channels
                fields['out_channels'] = int(m.group(3))
            continue
        v = m.group(2)
        if v.isdigit():
            fields[_FIELD_OF[m.group(1)]] = int(v)
        elif m.group(1) == '!':
            # a bare '!' still switches the token to a plain conv
            fields['conv_in_deconv'] = None

    if where != 'output':
        fields.pop('output_padding', None)
        fields.pop('conv_in_deconv', None)
    if 'conv_in_deconv' in fields:          # '!C': plain conv inside a deconv stack
        ltype = 'conv'
        out_channels = fields.pop('conv_in_deconv')
        fields.pop('out_channels', None)
        fields.pop('output_padding', None)

    is_convolution = ltype in ('conv', 'deconv')
    params = {'ltype': ltype,
              'kernel_size': fields.get('kernel_size', kernel_size),
              'padding': fields.get('padding', padding),
              'stride': fields.get('stride', stride)}
    if is_convolution:
        params['out_channels'] = fields.get('out_channels', out_channels)
    if ltype == 'deconv':
        params['output_padding'] = fields.get('output_padding', output_padding)

    if params['padding'] == '*':
        # 'same' resolves to k//2 only for input-side convs; output stacks
        # resolve '*' to 0 (ref conv.py:79-80)
        params['padding'] = (params['kernel_size'] // 2
                             if ltype == 'conv' and where != 'output' else 0)
    if params['stride'] is None:
        if is_convolution:
            params['stride'] = 1
        elif ltype.endswith('pooling'):
            params['stride'] = params['kernel_size']
    return params


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    ltype: str                       # conv | deconv | mpooling | apooling | upsampler
    out_channels: Optional[int]
    kernel_size: int
    padding: int
    stride: int
    output_padding: int = 0
    batch_norm: bool = False
    activation: Optional[str] = 'relu'   # None = no activation after
    out_shape: Tuple[int, int, int] = (0, 0, 0)   # (C, H, W)

    @property
    def token(self) -> str:
        """Canonical token (ref conv_layer_name, conv.py:89-105)."""
        if self.ltype in ('conv', 'deconv'):
            s = '{}x{}'.format(self.out_channels, self.kernel_size)
            if self.padding != self.kernel_size // 2:
                s += '+{}'.format(self.padding)
            if self.stride != 1:
                s += ':{}'.format(self.stride)
            return s
        if self.ltype.endswith('pooling'):
            s = '{}x{}'.format(self.ltype[0].upper(), self.kernel_size)
            if self.stride != self.kernel_size:
                s += ':{}'.format(self.stride)
            return s
        return 'u:{}'.format(self.stride)


def conv_stack_plan(input_shape: Sequence[int], layers_name: str,
                    where: str = 'input', batch_norm: bool = False,
                    activation: str = 'relu', output_activation: str = 'linear',
                    output_distribution: str = 'gaussian'):
    """Resolve a DSL string into a static list of LayerPlans with inferred
    shapes.  Returns (name, plans, output_shape); output_shape is
    (256, C, H, W) for categorical output stacks."""
    name = None
    if where == 'input' and layers_name in FEATURES_ARCHS:
        name, layers_name = layers_name, FEATURES_ARCHS[layers_name]
    if where == 'output' and layers_name in UPSAMPLER_ARCHS:
        name, layers_name = layers_name, UPSAMPLER_ARCHS[layers_name]

    if isinstance(input_shape, int):
        input_shape = (input_shape, 1, 1)

    default_params = {}
    if layers_name.startswith('['):
        end = layers_name.find(']')
        for tok in layers_name[1:end].split('-'):
            p = parse_conv_layer_name(tok, where=where)
            default_params[p.pop('ltype')] = p
        layers_name = layers_name[end + 1:]

    tokens = layers_name.split('-')
    plans: List[LayerPlan] = []
    c, h, w = input_shape

    for i, tok in enumerate(tokens):
        last = i == len(tokens) - 1
        p0 = parse_conv_layer_name(tok, where=where)
        p = parse_conv_layer_name(tok, **default_params.get(p0['ltype'], {}), where=where)
        ltype = p.pop('ltype')

        if where == 'output' and last and output_distribution == 'categorical':
            p['out_channels'] = 256 * p['out_channels']

        k, pad, s = p['kernel_size'], p['padding'], p['stride']
        act = activation if ltype.endswith('conv') else None
        bn = batch_norm and ltype.endswith('conv')
        if ltype == 'conv':
            c = p['out_channels']
            h = (h + 2 * pad - k) // s + 1
            w = (w + 2 * pad - k) // s + 1
        elif ltype == 'deconv':
            c = p['out_channels']
            h = (h - 1) * s - 2 * pad + k + p.get('output_padding', 0)
            w = (w - 1) * s - 2 * pad + k + p.get('output_padding', 0)
        elif ltype.endswith('pooling'):
            h = (h + 2 * pad - k) // s + 1
            w = (w + 2 * pad - k) // s + 1
        elif ltype == 'upsampler':
            h, w = int(h * s), int(w * s)
        else:
            raise ValueError(ltype)

        plans.append(LayerPlan(ltype=ltype, out_channels=p.get('out_channels'),
                               kernel_size=k, padding=pad, stride=s,
                               output_padding=p.get('output_padding', 0),
                               batch_norm=bn, activation=act,
                               out_shape=(c, h, w)))

    # the last activation of an output stack becomes the output activation
    if where == 'output':
        for j in range(len(plans) - 1, -1, -1):
            if plans[j].activation is not None:
                plans[j] = dataclasses.replace(plans[j], activation=output_activation)
                break

    out_shape = (c, h, w)
    if where == 'output' and output_distribution == 'categorical':
        out_shape = (256, c // 256, h, w)
    name = name or '-'.join(pl.token for pl in plans)
    return name, tuple(plans), out_shape


def find_input_shape(layers_name: str, wanted_output_shape: Sequence[int],
                     input_shape: Tuple[int, int] = (1, 1)) -> Tuple[int, int]:
    """Smallest (H, W) whose deconv output matches wanted (H, W)."""
    h, w = input_shape
    while True:
        _, _, out = conv_stack_plan((1, h, w), layers_name, where='output')
        oh, ow = out[-2], out[-1]
        if (oh, ow) == tuple(wanted_output_shape):
            return (h, w)
        if oh > wanted_output_shape[0] or ow > wanted_output_shape[1]:
            raise ValueError('Did not find an input shape yielding output size '
                             '({}, {}) for {}'.format(*wanted_output_shape, layers_name))
        h += int(oh < wanted_output_shape[0])
        w += int(ow < wanted_output_shape[1])


ACTIVATIONS = {
    'relu': torch.relu,
    'leaky': lambda x: F.leaky_relu(x, negative_slope=0.2),
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'linear': lambda x: x,
}


# ---------------------------------------------------------------------------
# Sub-pixel and matmul deconvs, as the JAX package lowers them
# (joint_vae_tpu/models/conv.py: _packed_geometry, _packed_kernel,
# depth_to_space, _unpack_to, _flipped_1x1_kernel).  A stride-s deconv is a
# dense conv from the input grid to s^2 phase-packed output channels (the
# ``f_in=1, f_out=s`` case of the packed lowering), then depth_to_space;
# where ceil(oh/s) == h and ceil(ow/s) == w that conv keeps the grid and
# runs on the same-grid kernel.  The packed kernel is a gather of the
# stored (k, k, Cin, Cout) parameter, so weights are lowering-agnostic.
# Packing never persists past the layer.
# ---------------------------------------------------------------------------

def _packed_geometry(k: int, off: int, num: int, den: int,
                     f_in: int, f_out: int):
    """Tap table of the packed lowering; returns (g, dmin, tap) with
    tap[a, qi, R] = original tap index t at packed offset d = dmin + a for
    input phase qi / output phase R, or -1 where no tap lands."""
    assert (num * f_out) % (den * f_in) == 0, (num, den, f_in, f_out)
    g = (num * f_out) // (den * f_in)
    entries = []
    for R in range(f_out):
        for qi in range(f_in):
            for t in range(k):
                n = num * R + t - off - den * qi
                if n % (den * f_in) == 0:
                    entries.append((R, qi, t, n // (den * f_in)))
    dmin = min(e[3] for e in entries)
    dmax = max(e[3] for e in entries)
    tap = np.full((dmax - dmin + 1, f_in, f_out), -1, np.int64)
    for R, qi, t, d in entries:
        tap[d - dmin, qi, R] = t
    return g, dmin, tap


def _packed_kernel(kern: torch.Tensor, tap_h, tap_w) -> torch.Tensor:
    """(k, k, Cin, Cout) -> (k'_h, k'_w, f_in^2 Cin, f_out^2 Cout); packed
    channel order is (phase_h, phase_w, channel) on both sides.  The tap
    tables may be numpy arrays or tensors (on ``kern``'s device, so that
    the gather copies nothing from the host)."""
    tap_h = torch.as_tensor(tap_h, device=kern.device)
    tap_w = torch.as_tensor(tap_w, device=kern.device)
    kph, fi, fo = tap_h.shape
    kpw = tap_w.shape[0]
    ih = tap_h.clamp(min=0)[:, None, :, None, :, None]
    iw = tap_w.clamp(min=0)[None, :, None, :, None, :]
    mask = ((tap_h >= 0)[:, None, :, None, :, None]
            & (tap_w >= 0)[None, :, None, :, None, :])
    g = kern[ih, iw]                     # (kph,kpw,fi,fi,fo,fo,Ci,Co)
    g = g * mask.to(kern.dtype)[..., None, None]
    ci, co = kern.shape[2], kern.shape[3]
    g = g.permute(0, 1, 2, 3, 6, 4, 5, 7)
    return g.reshape(kph, kpw, fi * fi * ci, fo * fo * co)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """(N, H, W, f^2 C), channel order (rh, rw, c) -> (N, fH, fW, C)."""
    if f == 1:
        return x
    n, hp, wp, cf = x.shape
    c = cf // (f * f)
    x = x.reshape(n, hp, wp, f, f, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, hp * f, wp * f, c)


def _unpack_to(x: torch.Tensor, f: int, h: int, w: int) -> torch.Tensor:
    """depth_to_space + slice to the true (h, w) when f does not divide."""
    y = depth_to_space(x, f)
    return y[:, :h, :w]


def _flipped_1x1_kernel(kern: torch.Tensor, k: int, p: int,
                        h_out: int) -> torch.Tensor:
    """(h_out, h_out, Cin, Cout) gather of K[A-m, A-n] (zero where invalid)."""
    A = k - 1 - p
    rows = []
    zero = torch.zeros_like(kern[0, 0])
    for m in range(h_out):
        cols = [kern[A - m, A - n] if 0 <= A - m < k and 0 <= A - n < k
                else zero for n in range(h_out)]
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def _subpixel_geometry(k: int, p: int, s: int):
    """(dmin, tap) of a stride-s deconv's packed same-grid conv."""
    _, dmin, tap = _packed_geometry(k, k - 1 - p, 1, s, 1, s)
    return dmin, tap


def conv_route(pl: LayerPlan, h: int, w: int) -> Tuple[str, Tuple[int, int]]:
    """(route, (pad_lo, pad_hi)) of a conv/deconv layer on an (h, w) input.

    Routes, in the JAX package's order of lowerings:

    - 'matmul': a deconv on a 1x1 input (the latent expansion), one
      ``torch.matmul`` with the gathered kernel (``_flipped_1x1_kernel``);
    - 'subpixel': a stride-s deconv whose packed conv keeps the grid,
      ceil(oh/s) == h and ceil(ow/s) == w with pads (-dmin, dmax) both
      >= 0: the same-grid kernel to s^2 phase-packed channels, then
      depth_to_space and a slice to (oh, ow);
    - 'same_grid': stride 1, output grid == input grid (a stride-1 deconv
      is the correlation with pads (k-1-p, k-1-p+op));
    - 'transpose' (``F.conv_transpose2d``): the other strided deconvs;
    - 'conv' (``F.conv2d``): strided convs and stride-1 convs that change
      the grid."""
    k, p, s, op = pl.kernel_size, pl.padding, pl.stride, pl.output_padding
    if pl.ltype == 'deconv':
        if h == 1 and w == 1:
            return 'matmul', (p, p)
        if s > 1:
            dmin, tap = _subpixel_geometry(k, p, s)
            dmax = dmin + tap.shape[0] - 1
            _, oh, ow = pl.out_shape
            if (-(-oh // s), -(-ow // s)) == (h, w) and dmin <= 0 <= dmax:
                return 'subpixel', (-dmin, dmax)
            return 'transpose', (p, p)
        pads = (k - 1 - p, k - 1 - p + op)
    else:
        pads = (p, p)
        if s > 1:
            return 'conv', pads
    if pads[0] >= 0 and pads[1] >= 0 and pads[0] + pads[1] == k - 1:
        return 'same_grid', pads
    return 'conv', pads


HWIO_ROUTES = ('same_grid', 'subpixel', 'matmul')


class ConvLayer(nn.Module):
    """One conv/deconv site of plan ``pl`` on an (h, w) input: ``weight``
    in its route's layout — HWIO for 'same_grid', 'subpixel' and 'matmul'
    (the stored JAX kernel; the latter two gather their packed or flipped
    kernel from it at each call), OIHW for 'conv', (Cin, Cout, kh, kw)
    spatially flipped for 'transpose' — and ``bias`` (Cout,)."""

    def __init__(self, pl: LayerPlan, in_channels: int, h: int, w: int):
        super().__init__()
        self.route, self.pads = conv_route(pl, h, w)
        self.kernel_size, self.stride = pl.kernel_size, pl.stride
        self.padding, self.output_padding = pl.padding, pl.output_padding
        self.out_hw = tuple(pl.out_shape[1:])
        k, co = pl.kernel_size, pl.out_channels
        if self.route == 'subpixel':      # follows the module's device
            self.register_buffer('tap', torch.as_tensor(_subpixel_geometry(
                k, pl.padding, pl.stride)[1]), persistent=False)
        shape = ((k, k, in_channels, co) if self.route in HWIO_ROUTES else
                 {'conv': (co, in_channels, k, k),
                  'transpose': (in_channels, co, k, k)}[self.route])
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(co))

    def from_hwio(self, k: torch.Tensor) -> torch.Tensor:
        """Stored JAX kernel (k, k, Cin, Cout), correlation-oriented ->
        this layer's layout."""
        if self.route in HWIO_ROUTES:
            return k
        if self.route == 'conv':
            return k.permute(3, 2, 0, 1)
        return torch.flip(k, (0, 1)).permute(2, 3, 0, 1)

    def to_hwio(self, wt: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`from_hwio`."""
        if self.route in HWIO_ROUTES:
            return wt
        if self.route == 'conv':
            return wt.permute(2, 3, 1, 0)
        return torch.flip(wt.permute(2, 3, 0, 1), (0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (n, h, w, c) NHWC -> NHWC, bias added."""
        wt = self.weight.to(x.dtype)
        if self.route == 'same_grid':
            lo = self.pads[0]
            y = SameGridConvFn.apply(x.contiguous(), wt, lo, lo)
        elif self.route == 'subpixel':
            lo = self.pads[0]
            kd = _packed_kernel(wt, self.tap, self.tap).contiguous()
            y = _unpack_to(SameGridConvFn.apply(x.contiguous(), kd, lo, lo),
                           self.stride, *self.out_hw)
        elif self.route == 'matmul':
            k, p = self.kernel_size, self.padding
            kf = _flipped_1x1_kernel(wt, k, p, k - 2 * p + self.output_padding)
            ho, wo, ci, co = kf.shape
            y = torch.matmul(x[:, 0, 0, :], kf.permute(2, 0, 1, 3).reshape(
                ci, ho * wo * co)).reshape(x.shape[0], ho, wo, co)
        else:
            xc = x.permute(0, 3, 1, 2)
            if self.route == 'conv':
                lo, hi = self.pads
                if lo != hi or lo < 0:
                    xc = F.pad(xc, (lo, hi, lo, hi))
                    lo = 0
                y = F.conv2d(xc, wt, stride=self.stride, padding=lo)
            else:
                y = F.conv_transpose2d(xc, wt, stride=self.stride,
                                       padding=self.padding,
                                       output_padding=self.output_padding)
            y = y.permute(0, 2, 3, 1)
        return y + self.bias.to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis with flax ``nn.BatchNorm``
    semantics (epsilon 1e-5, momentum 0.99).  At inference it normalises
    with the running statistics.  In training it normalises with the batch
    mean and the biased batch variance over every other axis (flax's
    E[x^2] - E[x]^2, clipped at 0) and, when ``updates`` is a dict, records
    the new running statistics there under this module:
    ``0.99 running + 0.01 batch`` (the biased variance again); the buffers
    change only when the caller applies them (``apply_bn_updates``)."""

    momentum = 0.99

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))     # flax 'scale'
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                updates: Optional[dict] = None) -> torch.Tensor:
        if train:
            axes = tuple(range(x.ndim - 1))
            xf = x.float()
            mean = torch.mean(xf, dim=axes)
            var = torch.clamp(torch.mean(torch.square(xf), dim=axes)
                              - torch.square(mean), min=0.0)
            if updates is not None:
                m = self.momentum
                updates[self] = (
                    m * self.running_mean + (1 - m) * mean.detach(),
                    m * self.running_var + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.to(x.dtype)) * mul.to(x.dtype)
                + self.bias.to(x.dtype))


def apply_bn_updates(updates: dict) -> None:
    """Copy the running statistics recorded by BatchNorm modules in
    training (``{module: (mean, var)}``) into their buffers."""
    with torch.no_grad():
        for bn, (mean, var) in updates.items():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)


class ConvStack(nn.Module):
    """A (de)conv stack executing a static plan; (..., C, H, W) in and out,
    NHWC inside.  Leading axes of any rank ride through as one batch."""

    def __init__(self, input_shape: Tuple[int, int, int],
                 plans: Tuple[LayerPlan, ...],
                 output_distribution: str = 'gaussian', where: str = 'input',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.plans = tuple(plans)
        self.output_distribution = output_distribution
        self.where = where
        self.dtype = dtype
        c, h, w = self.input_shape
        for i, pl in enumerate(self.plans):
            if pl.ltype in ('conv', 'deconv'):
                self.add_module(
                    ('deconv_{}' if pl.ltype == 'deconv' else 'conv_{}').format(i),
                    ConvLayer(pl, c, h, w))
            if pl.batch_norm:
                self.add_module('bn_{}'.format(i), BatchNorm(pl.out_shape[0]))
            c, h, w = pl.out_shape

    def conv_layers(self):
        """(name, ConvLayer) in stack order."""
        return [(n, m) for n, m in self.named_children()
                if isinstance(m, ConvLayer)]

    def forward(self, x: torch.Tensor, train: bool = False,
                bn_updates: Optional[dict] = None) -> torch.Tensor:
        """``train`` switches BatchNorm to batch statistics, recorded
        into ``bn_updates`` when given (:class:`BatchNorm`)."""
        lead = x.shape[:-3]
        c0, h0, w0 = self.input_shape
        x = x.reshape((-1, c0, h0, w0)).permute(0, 2, 3, 1).to(self.dtype)
        for i, pl in enumerate(self.plans):
            if pl.ltype in ('conv', 'deconv'):
                x = getattr(self, ('deconv_{}' if pl.ltype == 'deconv'
                                   else 'conv_{}').format(i))(x)
            else:
                xc = x.permute(0, 3, 1, 2)
                if pl.ltype == 'mpooling':
                    xc = F.max_pool2d(xc, pl.kernel_size, pl.stride, pl.padding)
                elif pl.ltype == 'apooling':
                    xc = F.avg_pool2d(xc, pl.kernel_size, pl.stride, pl.padding,
                                      count_include_pad=True)
                else:
                    xc = xc.repeat_interleave(pl.stride, dim=2) \
                           .repeat_interleave(pl.stride, dim=3)
                x = xc.permute(0, 2, 3, 1)
            if pl.batch_norm:
                x = getattr(self, 'bn_{}'.format(i))(x, train, bn_updates)
            if pl.activation is not None:
                x = ACTIVATIONS[pl.activation](x)
        x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        c, h, w = self.plans[-1].out_shape
        if self.where == 'output' and self.output_distribution == 'categorical':
            return x.reshape(lead + (256, c // 256, h, w))
        return x.reshape(lead + (c, h, w))
