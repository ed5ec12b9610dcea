"""ResNet and DenseNet feature trunks (ref ResOrDenseNetFeatures,
module/vae_layers/conv.py:247-272).

Port of ``joint_vae_tpu/models/resnet.py``:

- :class:`ResNetFeatures`: torchvision's resnet trunk (conv 7x7/2, BN,
  ReLU, max-pool 3x3/2, four layers of :class:`_BasicBlock` for
  resnet18/34 or :class:`_Bottleneck` for resnet50/101/152, global
  average pool) -> (..., width * 8 * expansion, 1, 1);
- :class:`DenseNetFeatures`: densenet121/161/169/201 as torchvision builds
  them (7x7/2 stem, norm0, max-pool, dense blocks and transitions, the
  pre-ReLU norm5 map at (C, ~h/32, ~w/32)), and the compact
  ``densenet-small`` / ``densenet-tiny`` (3x3 stem, global average pool
  to (C, 1, 1)).

The convolutions are bias-free ``F.conv2d`` (cuDNN on the card) with
OIHW weights; activations stay NHWC between them, so each conv sees a
channels-last view.  In float32 and float64 a conv's backward is
``models/conv.py::DeterministicConvFn``'s: dx on cuDNN's deterministic
algorithms, so that a train step repeats from a seed, and on the card dw
the im2col product summed in float32 (float64), as precise as the CPU's
float32 wgrad where cuDNN's is not; on the CPU dw stays the autograd of
``F.conv2d`` bit for bit.  bfloat16 keeps ``F.conv2d``'s autograd, which
repeats.  BatchNorm is ``models/conv.py::BatchNorm`` (flax
semantics: biased batch variance, momentum 0.99, epsilon 1e-5), and the
running statistics of a training pass go to ``bn_updates`` as in the
conv stacks.  Max-pooling pads with -inf and average-pooling floors, as
flax's ``max_pool`` and ``avg_pool`` (VALID) do.  Submodules carry
flax's automatic names (``Conv_0``, ``BatchNorm_1``, ``_BasicBlock_3``,
``_DenseLayer_7``), so ``save_load/from_jax.py`` maps a JAX tree path to
a ``state_dict`` key by swapping '/' for '.'.
"""

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv import BatchNorm, DeterministicConvFn

RESNET_LAYERS = {
    'resnet18': (2, 2, 2, 2),
    'resnet34': (3, 4, 6, 3),
    'resnet50': (3, 4, 6, 3),
    'resnet101': (3, 4, 23, 3),
    'resnet152': (3, 8, 36, 3),
}

# torchvision block expansion: BasicBlock nets output width*8 channels,
# Bottleneck nets width*8*4 (the reference's default trunk is resnet152,
# ref module/vae_layers/conv.py:249)
RESNET_EXPANSION = {
    'resnet18': 1, 'resnet34': 1,
    'resnet50': 4, 'resnet101': 4, 'resnet152': 4,
}

DENSENET_LAYERS = {
    'densenet121': (6, 12, 24, 16),
    'densenet161': (6, 12, 36, 24),
    'densenet169': (6, 12, 32, 32),
    'densenet201': (6, 12, 48, 32),
    'densenet-small': (2, 4, 4, 2),
    'densenet-tiny': (1, 2),
}

# torchvision-faithful archs: (growth_rate, init_features); the others
# keep the compact from-scratch layout
DENSENET_TV = {
    'densenet121': (32, 64),
    'densenet161': (48, 96),
    'densenet169': (32, 64),
    'densenet201': (32, 64),
}


class TrunkConv(nn.Module):
    """A bias-free conv (flax ``nn.Conv(use_bias=False)``) on NHWC
    activations; ``weight`` is OIHW, the layout ``F.conv2d`` takes.  A
    float32 or float64 input goes through ``DeterministicConvFn``, with
    the im2col weight gradient on a CUDA tensor (module docstring)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))

    @staticmethod
    def from_hwio(k: torch.Tensor) -> torch.Tensor:
        """JAX kernel (kh, kw, Cin, Cout) -> OIHW."""
        return k.permute(3, 2, 0, 1)

    @staticmethod
    def to_hwio(wt: torch.Tensor) -> torch.Tensor:
        return wt.permute(2, 3, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc, wt = x.permute(0, 3, 1, 2), self.weight.to(x.dtype)
        if x.dtype in (torch.float32, torch.float64):
            y = DeterministicConvFn.apply(xc, wt, self.stride, self.padding,
                                          x.is_cuda)
        else:
            y = F.conv2d(xc, wt, stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


def _pool(x: torch.Tensor, kind: str, k: int, s: int, p: int = 0):
    """NHWC pooling: 'max' pads with -inf, 'avg' is VALID (floors)."""
    xc = x.permute(0, 3, 1, 2)
    y = (F.max_pool2d(xc, k, s, p) if kind == 'max'
         else F.avg_pool2d(xc, k, s))
    return y.permute(0, 2, 3, 1)


class _Trunk(nn.Module):
    """Holds flax-named children and applies BatchNorm with the trunk's
    mode and update dict."""

    def _bn(self, i: int, x, train: bool, bn_updates: Optional[dict]):
        return getattr(self, 'BatchNorm_{}'.format(i))(x, train, bn_updates)

    def _conv(self, i: int, x):
        return getattr(self, 'Conv_{}'.format(i))(x)


class _BasicBlock(_Trunk):
    """Two 3x3 convs and an identity or projection shortcut (torchvision's
    BasicBlock; downsample = 1x1 conv + BN when the shape changes)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = TrunkConv(cin, features, 3, stride, 1)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = TrunkConv(features, features, 3, 1, 1)
        self.BatchNorm_1 = BatchNorm(features)
        self.project = stride != 1 or cin != features
        if self.project:
            self.Conv_2 = TrunkConv(cin, features, 1, stride)
            self.BatchNorm_2 = BatchNorm(features)
        self.out_channels = features

    def forward(self, x, train=False, bn_updates=None):
        y = torch.relu(self._bn(0, self._conv(0, x), train, bn_updates))
        y = self._bn(1, self._conv(1, y), train, bn_updates)
        res = (self._bn(2, self._conv(2, x), train, bn_updates)
               if self.project else x)
        return torch.relu(y + res)


class _Bottleneck(_Trunk):
    """1x1 reduce, 3x3 (stride here), 1x1 expand to 4x, and a shortcut
    (torchvision's Bottleneck)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = TrunkConv(cin, features, 1)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = TrunkConv(features, features, 3, stride, 1)
        self.BatchNorm_1 = BatchNorm(features)
        self.Conv_2 = TrunkConv(features, 4 * features, 1)
        self.BatchNorm_2 = BatchNorm(4 * features)
        self.project = stride != 1 or cin != 4 * features
        if self.project:
            self.Conv_3 = TrunkConv(cin, 4 * features, 1, stride)
            self.BatchNorm_3 = BatchNorm(4 * features)
        self.out_channels = 4 * features

    def forward(self, x, train=False, bn_updates=None):
        y = torch.relu(self._bn(0, self._conv(0, x), train, bn_updates))
        y = torch.relu(self._bn(1, self._conv(1, y), train, bn_updates))
        y = self._bn(2, self._conv(2, y), train, bn_updates)
        res = (self._bn(3, self._conv(3, x), train, bn_updates)
               if self.project else x)
        return torch.relu(y + res)


class _DenseLayer(_Trunk):
    """BN-ReLU-1x1 (4 growth) - BN-ReLU-3x3 (growth), concatenated to its
    input."""

    def __init__(self, cin: int, growth: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(cin)
        self.Conv_0 = TrunkConv(cin, 4 * growth, 1)
        self.BatchNorm_1 = BatchNorm(4 * growth)
        self.Conv_1 = TrunkConv(4 * growth, growth, 3, 1, 1)

    def forward(self, x, train=False, bn_updates=None):
        y = self._conv(0, torch.relu(self._bn(0, x, train, bn_updates)))
        y = self._conv(1, torch.relu(self._bn(1, y, train, bn_updates)))
        return torch.cat([x, y], dim=-1)


def _flatten_input(x: torch.Tensor, dtype: torch.dtype):
    """(..., C, H, W) -> (lead, NHWC batch in ``dtype``)."""
    lead = x.shape[:-3]
    c, h, w = x.shape[-3:]
    return lead, x.reshape((-1, c, h, w)).permute(0, 2, 3, 1).to(dtype)


class ResNetFeatures(_Trunk):
    """(..., 3, H, W) -> (..., width * 8 * expansion, 1, 1)."""

    def __init__(self, arch: str = 'resnet18', width: int = 64,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.arch, self.width, self.dtype = arch, width, dtype
        self.Conv_0 = TrunkConv(in_channels, width, 7, 2, 3)
        self.BatchNorm_0 = BatchNorm(width)
        bottleneck = RESNET_EXPANSION[arch] == 4
        block = _Bottleneck if bottleneck else _BasicBlock
        name = '_Bottleneck_{}' if bottleneck else '_BasicBlock_{}'
        self.blocks = []
        c, f = width, width
        for i, n in enumerate(RESNET_LAYERS[arch]):
            for j in range(n):
                b = block(c, f, 2 if (j == 0 and i > 0) else 1)
                self.add_module(name.format(len(self.blocks)), b)
                self.blocks.append(b)
                c = b.out_channels
            f *= 2

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        return (self.width * 8 * RESNET_EXPANSION[self.arch], 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                bn_updates: Optional[dict] = None) -> torch.Tensor:
        lead, x = _flatten_input(x, self.dtype)
        x = torch.relu(self._bn(0, self._conv(0, x), train, bn_updates))
        x = _pool(x, 'max', 3, 2, 1)
        for b in self.blocks:
            x = b(x, train, bn_updates)
        x = torch.mean(x, dim=(1, 2))                  # global average pool
        return x.reshape(lead + (x.shape[-1], 1, 1))


class DenseNetFeatures(_Trunk):
    """DenseNet-BC trunk.  densenet121/161/169/201 output the pre-ReLU
    norm5 map at (C, h', w') (``_tv_spatial``); densenet-small/-tiny
    global-average-pool to (C, 1, 1).  ``growth`` / ``init_features`` of
    0 mean the arch's default."""

    def __init__(self, arch: str = 'densenet121', growth: int = 0,
                 init_features: int = 0, input_hw: Tuple[int, int] = (32, 32),
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        g0, f0 = DENSENET_TV.get(arch, (32, 64))
        self.arch, self.dtype = arch, dtype
        self.growth, self.init_features = growth or g0, init_features or f0
        self.input_hw = tuple(input_hw)
        self.tv = arch in DENSENET_TV
        f = self.init_features
        if self.tv:
            self.Conv_0 = TrunkConv(in_channels, f, 7, 2, 3)
            self.BatchNorm_0 = BatchNorm(f)
        else:
            self.Conv_0 = TrunkConv(in_channels, f, 3, 1, 1)
        n_bn, n_conv = int(self.tv), 1
        blocks = DENSENET_LAYERS[arch]
        self.stages = []              # per block: its layers, then its transition
        n_layer = 0
        for bi, n in enumerate(blocks):
            layers = []
            for _ in range(n):
                layer = _DenseLayer(f, self.growth)
                self.add_module('_DenseLayer_{}'.format(n_layer), layer)
                layers.append(layer)
                n_layer += 1
                f += self.growth
            trans = None
            if bi != len(blocks) - 1:
                self.add_module('BatchNorm_{}'.format(n_bn), BatchNorm(f))
                self.add_module('Conv_{}'.format(n_conv),
                                TrunkConv(f, f // 2, 1))
                trans = (n_bn, n_conv)
                n_bn, n_conv = n_bn + 1, n_conv + 1
                f //= 2
            self.stages.append((layers, trans))
        self.norm5 = None
        if self.tv:
            self.add_module('BatchNorm_{}'.format(n_bn), BatchNorm(f))
            self.norm5 = n_bn

    @staticmethod
    def _tv_spatial(size: int, transitions: int) -> int:
        """torchvision's spatial arithmetic: conv0 k7/s2/p3, pool0
        k3/s2/p1, then one 2x2/2 floor avg-pool per transition."""
        size = (size + 1) // 2
        size = (size + 1) // 2
        for _ in range(transitions):
            size //= 2
        return size

    @property
    def output_shape(self) -> Tuple[int, int, int]:
        blocks = DENSENET_LAYERS[self.arch]
        f = self.init_features
        for bi, n in enumerate(blocks):
            f += n * self.growth
            if bi != len(blocks) - 1:
                f = f // 2
        if self.tv:
            h, w = (self._tv_spatial(s, len(blocks) - 1)
                    for s in self.input_hw)
            if h < 1 or w < 1:
                raise ValueError(
                    'input {}x{} is too small for the /32 torchvision '
                    'trunk {} (needs >=29px); use densenet-small/-tiny '
                    'for small inputs'.format(*self.input_hw, self.arch))
            return (f, h, w)
        return (f, 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                bn_updates: Optional[dict] = None) -> torch.Tensor:
        lead, x = _flatten_input(x, self.dtype)
        x = self._conv(0, x)
        if self.tv:
            x = torch.relu(self._bn(0, x, train, bn_updates))
            x = _pool(x, 'max', 3, 2, 1)
        for layers, trans in self.stages:
            for layer in layers:
                x = layer(x, train, bn_updates)
            if trans is not None:
                x = torch.relu(self._bn(trans[0], x, train, bn_updates))
                x = _pool(self._conv(trans[1], x), 'avg', 2, 2)
        if self.tv:
            # norm5 and no ReLU: the reference keeps children()[:-1]
            x = self._bn(self.norm5, x, train, bn_updates).permute(0, 3, 1, 2)
            return x.reshape(lead + tuple(x.shape[1:]))
        x = torch.mean(x, dim=(1, 2))
        return x.reshape(lead + (x.shape[-1], 1, 1))


def build_trunk(features: str, input_shape: Tuple[int, int, int],
                dtype: torch.dtype = torch.float32) -> nn.Module:
    """The trunk a ``features`` string names: 'resnet18', 'resnet18:16'
    (base width 16), 'densenet121', 'densenet121:12' (growth rate 12)."""
    arch, _, width = features.partition(':')
    if arch.startswith('resnet'):
        kw = {'width': int(width)} if width else {}
        return ResNetFeatures(arch, in_channels=input_shape[0], dtype=dtype,
                              **kw)
    kw = {'growth': int(width)} if width else {}
    return DenseNetFeatures(arch, input_hw=tuple(input_shape[-2:]),
                            in_channels=input_shape[0], dtype=dtype, **kw)
