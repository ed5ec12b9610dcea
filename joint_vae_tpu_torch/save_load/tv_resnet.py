"""torchvision's resnet18/34/50/101/152 and densenet121/161/169/201
module graphs in plain PyTorch.

The port's own copy of ``joint_vae_tpu/save_load/tv_resnet.py``: the same
attribute order (conv1, bn1, relu, maxpool, layer1..4, avgpool, fc; the
DenseNet's ``features`` children conv0/norm0/..., denseblockB.denselayerL,
transitionT, norm5), the same state_dict keys and shapes, written from the
architecture (He 2015 / the torchvision docs).  The reference wraps
``torchvision.models.<arch>()`` and keeps ``children()[:-1]`` (ref
module/vae_layers/conv.py:247-272), so a reference job's ``state.pth``
keys its trunk as ``features.<i>...`` over those children; these modules
write such a trunk where torchvision is not installed (the import tests
and ``chip_smoke.py``).  ``pretrained`` is accepted and ignored: the
weights are random (``torch.manual_seed``), pretrained values arrive
inside a reference job's ``state.pth``.

For the exporter (``export_reference.py``), which builds its template
network with the reference checkout's own code: ``install`` attaches
these factories to a torchvision stub's ``models`` module where the real
package is absent, and ``route_densenet`` repairs the checkout's trunk
routing, which sends only ``resnet*`` names to ``ResOrDenseNetFeatures``
(ref module/vae_layers/conv.py:138), so that a densenet-trunk job's
template builds.
"""

import sys

import torch
import torch.nn as nn


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        # stride on the 3x3 (torchvision's post-v0.4 "ResNet B" placement)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, layers, num_classes=1000, block=BasicBlock):
        super().__init__()
        self.block = block
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = self._make_layer(64, layers[0])
        self.layer2 = self._make_layer(128, layers[1], stride=2)
        self.layer3 = self._make_layer(256, layers[2], stride=2)
        self.layer4 = self._make_layer(512, layers[3], stride=2)
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, planes, blocks, stride=1):
        block, exp = self.block, self.block.expansion
        downsample = None
        if stride != 1 or self.inplanes != planes * exp:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * exp, 1, stride,
                          bias=False),
                nn.BatchNorm2d(planes * exp))
        mods = [block(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * exp
        mods += [block(self.inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        x = torch.flatten(self.avgpool(x), 1)
        return self.fc(x)


def _resnet_factory(arch):
    # block counts and expansion from the port's trunk tables
    # (models/resnet.py), the trunks these weights are mapped onto
    from ..models.resnet import RESNET_LAYERS, RESNET_EXPANSION

    def factory(pretrained=False, **kw):  # noqa: U100 — torchvision signature
        block = BasicBlock if RESNET_EXPANSION[arch] == 1 else Bottleneck
        return ResNet(list(RESNET_LAYERS[arch]), block=block)
    factory.__name__ = arch
    return factory


resnet18 = _resnet_factory('resnet18')
resnet34 = _resnet_factory('resnet34')
resnet50 = _resnet_factory('resnet50')
resnet101 = _resnet_factory('resnet101')
resnet152 = _resnet_factory('resnet152')


class _TVDenseLayer(nn.Module):
    def __init__(self, in_ch, growth, bn_size=4):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(in_ch)
        self.relu1 = nn.ReLU(inplace=True)
        self.conv1 = nn.Conv2d(in_ch, bn_size * growth, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(bn_size * growth)
        self.relu2 = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(bn_size * growth, growth, 3, 1, 1, bias=False)

    def forward(self, x):
        y = self.conv1(self.relu1(self.norm1(x)))
        y = self.conv2(self.relu2(self.norm2(y)))
        return torch.cat([x, y], 1)


class DenseNet(nn.Module):
    """torchvision DenseNet module graph — same feature submodule names
    (conv0/norm0/relu0/pool0, denseblockB.denselayerL.{norm1,conv1,norm2,
    conv2}, transitionT.{norm,relu,conv,pool}, norm5) and state_dict key
    layout, so ``children()[:-1]`` wrapping and weight transplant behave
    exactly like the real package."""

    def __init__(self, growth, layers, init_features, num_classes=1000):
        super().__init__()
        from collections import OrderedDict
        feats = OrderedDict()
        feats['conv0'] = nn.Conv2d(3, init_features, 7, 2, 3, bias=False)
        feats['norm0'] = nn.BatchNorm2d(init_features)
        feats['relu0'] = nn.ReLU(inplace=True)
        feats['pool0'] = nn.MaxPool2d(3, 2, 1)
        ch = init_features
        for b, n in enumerate(layers, 1):
            feats['denseblock%d' % b] = nn.Sequential(OrderedDict(
                ('denselayer%d' % (i + 1),
                 _TVDenseLayer(ch + i * growth, growth))
                for i in range(n)))
            ch += n * growth
            if b != len(layers):
                feats['transition%d' % b] = nn.Sequential(OrderedDict([
                    ('norm', nn.BatchNorm2d(ch)),
                    ('relu', nn.ReLU(inplace=True)),
                    ('conv', nn.Conv2d(ch, ch // 2, 1, bias=False)),
                    ('pool', nn.AvgPool2d(2, 2))]))
                ch //= 2
        feats['norm5'] = nn.BatchNorm2d(ch)
        self.features = nn.Sequential(feats)
        self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        f = torch.relu(self.features(x))
        f = nn.functional.adaptive_avg_pool2d(f, (1, 1)).flatten(1)
        return self.classifier(f)


def _densenet_factory(arch):
    from ..models.resnet import DENSENET_LAYERS, DENSENET_TV

    def factory(pretrained=False, **kw):  # noqa: U100
        growth, init_features = DENSENET_TV[arch]
        return DenseNet(growth, DENSENET_LAYERS[arch], init_features)
    factory.__name__ = arch
    return factory


densenet121 = _densenet_factory('densenet121')
densenet161 = _densenet_factory('densenet161')
densenet169 = _densenet_factory('densenet169')
densenet201 = _densenet_factory('densenet201')


def route_densenet(ref_cvae):
    """Wrap the ``build_de_conv_layers`` that the checkout's ``cvae``
    module imported, so that ``densenet*`` feature names reach
    ``ResOrDenseNetFeatures`` of the same module (ref conv.py:247-272)
    instead of the conv-DSL fallthrough.  Idempotent (the mark is the
    JAX package's, so neither package wraps the other's wrapper)."""
    orig = ref_cvae.build_de_conv_layers
    if getattr(orig, '_jvt_densenet_routed', False):
        return

    def routed(input_shape, layers_name, *a, **kw):
        if (kw.get('where', 'input') == 'input'
                and str(layers_name).startswith('densenet')):
            conv_mod = sys.modules[orig.__module__]
            return conv_mod.ResOrDenseNetFeatures(
                model_name=layers_name, input_shape=input_shape)
        return orig(input_shape, layers_name, *a, **kw)

    routed._jvt_densenet_routed = True
    ref_cvae.build_de_conv_layers = routed


def install():
    """Attach the factories to a torchvision stub's ``models`` module
    (instance attributes win over the stub's ``__getattr__``); a real
    torchvision (its modules have a ``__file__``) is left as it is."""
    m = sys.modules.get('torchvision.models')
    if m is not None and getattr(m, '__file__', None) is None:
        for arch in ('resnet18', 'resnet34', 'resnet50', 'resnet101',
                     'resnet152', 'densenet121', 'densenet161',
                     'densenet169', 'densenet201'):
            setattr(m, arch, globals()[arch])
