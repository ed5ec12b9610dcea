#!/usr/bin/env python3
"""Precision of the ResNet trunk's gradients on the card, with and without
the reference run's discrete choices imposed.

    python3 scripts/time_torch_trunk_grads.py
    python3 scripts/time_torch_trunk_grads.py --cpu-only    # no card needed

``models/resnet.py::ResNetFeatures('resnet18')`` at full width, batch 64
of 32x32 inputs, random weights from a numpy seed, the loss a random
projection of its output: the gradient of every parameter, in training
mode (batch statistics) and in inference mode (running statistics), each
held against the CPU in float64 by its rms-relative error
||got - ref|| / ||ref|| and by its worst element, max |got - ref| /
(|ref| + rms(ref)) (``chip_smoke.py``'s training-gate form).  The runs:

- ``cpu_f64_ulp``: the CPU in float64 at the input moved by one float32
  ulp (up or down at random per element);
- ``cpu_f32``: the CPU in float32;
- ``cpu_f32_bn64``, ``cpu_f32_conv64`` and ``cpu_f32_conv_bn64``: the CPU
  in float32 with each BatchNorm, each trunk conv, or both computed in
  float64 (their inputs and weights cast up, their outputs rounded to
  float32): which ops' float32 roundings set the training-mode error;
- ``card``: the card in float32 on the port's route
  (``models/conv.py::DeterministicConvFn`` with the im2col weight
  gradient: cuDNN's forward, its deterministic dx, dw a cuBLAS product);
- ``card_no_cudnn``: the same with cuDNN off (PyTorch's own CUDA
  convolutions for the forward and dx);
- ``card_cudnn_autograd`` and ``card_cudnn_autograd_deterministic``: the
  card in float32 through ``F.conv2d``'s own autograd on cuDNN (its
  default algorithms, then ``cudnn.deterministic``), cuDNN's float32 wgrad
  for dw: the trunk's route before the im2col product;

each plain (its own ReLU masks and max-pool argmaxes) and ``_imposed``:
with the reference run's choices imposed (``tests/torch_choices.py``),
beside the number of elements where the imposed choice differs from the
run's own and the worst such element's distance to its tie (in units of
the rms of its op's input).  Prints the card's name and power limit, then
one JSON line per mode with the worst tensors.  ``--cpu-only`` runs the
CPU's cases alone, without a card.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

import torch.nn.functional as F  # noqa: E402

from joint_vae_tpu_torch.device import set_float32_math  # noqa: E402
from joint_vae_tpu_torch.models.conv import BatchNorm  # noqa: E402
from joint_vae_tpu_torch.models.resnet import (ResNetFeatures,  # noqa: E402
                                               TrunkConv)
from joint_vae_tpu_torch.parallel.mesh import batch_moments  # noqa: E402
from torch_choices import Choices, moved_ulp  # noqa: E402

N = 64
CASES = ('cpu_f64_ulp', 'cpu_f32', 'cpu_f32_bn64', 'cpu_f32_conv64',
         'cpu_f32_conv_bn64', 'card', 'card_no_cudnn', 'card_cudnn_autograd',
         'card_cudnn_autograd_deterministic')


def _bn64(self, x, train=False, updates=None):
    """``BatchNorm.forward`` in float64, rounded to x's dtype."""
    xd = x.double()
    if train:
        mean, var = batch_moments(xd, tuple(range(xd.ndim - 1)))
    else:
        mean, var = self.running_mean.double(), self.running_var.double()
    mul = torch.rsqrt(var + self.eps) * self.weight.double()
    return ((xd - mean) * mul + self.bias.double()).to(x.dtype)


def _conv64(self, x):
    """``TrunkConv.forward`` in float64, rounded to x's dtype."""
    y = F.conv2d(x.double().permute(0, 3, 1, 2), self.weight.double(),
                 stride=self.stride, padding=self.padding)
    return y.permute(0, 2, 3, 1).to(x.dtype)


@contextlib.contextmanager
def route(name: str):
    """The backend switches and the trunk conv's route of a case."""
    real, real_bn = TrunkConv.forward, BatchNorm.forward

    def autograd(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)
    torch.backends.cudnn.enabled = name != 'card_no_cudnn'
    torch.backends.cudnn.deterministic = name.endswith('deterministic')
    if 'autograd' in name:
        TrunkConv.forward = autograd
    if name.endswith(('_conv64', '_conv_bn64')):
        TrunkConv.forward = _conv64
    if name.endswith('bn64'):
        BatchNorm.forward = _bn64
    try:
        yield
    finally:
        TrunkConv.forward, BatchNorm.forward = real, real_bn
        torch.backends.cudnn.enabled = True
        torch.backends.cudnn.deterministic = False


def grads(model, x, w, dev, dt, train, choices=None, impose=False):
    """Every parameter's gradient (and the output) of the projected loss;
    ``choices`` recorded, or imposed with ``impose``.  Returns them and the
    replay's summary when imposing."""
    m = ResNetFeatures('resnet18')
    m.load_state_dict(model.state_dict())
    m = m.to(dev, dt)
    m.dtype = dt
    summary = None
    if choices is None:
        y = m(x.to(dev, dt), train, {}).reshape(N, -1)
    elif impose:
        with choices.imposing() as replay:
            y = m(x.to(dev, dt), train, {}).reshape(N, -1)
        summary = replay.summary()
    else:
        with choices.recording():
            y = m(x.to(dev, dt), train, {}).reshape(N, -1)
    g = torch.autograd.grad((y * w.to(dev, dt)).sum(), list(m.parameters()))
    out = {k: v.cpu().double() for (k, _), v in zip(m.named_parameters(), g)}
    out['output'] = y.detach().cpu().double()
    return out, summary


def main():
    cpu_only = sys.argv[1:] == ['--cpu-only']
    if not cpu_only and not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card (or --cpu-only)')
    set_float32_math()
    if not cpu_only:
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    model = ResNetFeatures('resnet18')
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.ndim == 4:
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                         / np.sqrt(np.prod(t.shape[1:]))))
    xs = rng.uniform(0, 1, (N, 3, 32, 32)).astype(np.float32)
    x = torch.from_numpy(xs)
    x_ulp = torch.from_numpy(moved_ulp(xs))
    w = torch.from_numpy(rng.standard_normal((N, 512)).astype(np.float32))
    for train in (True, False):
        choices = Choices()
        ref, _ = grads(model, x, w, 'cpu', torch.float64, train, choices)
        runs, flips = {}, {}
        for name in CASES:
            if cpu_only and not name.startswith('cpu'):
                continue
            xin = x_ulp if name == 'cpu_f64_ulp' else x
            dev = 'cpu' if name.startswith('cpu') else 'cuda'
            dt = torch.float64 if name == 'cpu_f64_ulp' else torch.float32
            with route(name):
                runs[name], _ = grads(model, xin, w, dev, dt, train)
                runs[name + '_imposed'], s = grads(model, xin, w, dev, dt,
                                                   train, choices, True)
            flips[name] = {k: s[k] for k in ('choices', 'flips',
                                             'flips_by_kind',
                                             'worst_distance')}
            flips[name]['first'] = s['first_flips'][:3]
        err = {r: {k: ((g[k] - ref[k]).norm() / ref[k].norm()).item()
                   for k in ref} for r, g in runs.items()}
        elem = {r: {k: ((g[k] - ref[k]).abs() / (ref[k].abs() + ref[k]
                                                 .square().mean().sqrt())
                        ).max().item() for k in ref}
                for r, g in runs.items()}
        print(json.dumps({
            'mode': 'train' if train else 'inference', 'batch': N,
            'choices': choices.counts(),
            'worst': {r: max(e.values()) for r, e in err.items()},
            'median': {r: float(np.median(list(e.values())))
                       for r, e in err.items()},
            'worst_element': {r: max(e.values()) for r, e in elem.items()},
            'top_element_imposed': {
                r: sorted(elem[r].items(), key=lambda kv: -kv[1])[:4]
                for r in elem if r.endswith('_imposed')},
            'flips': flips}),
              flush=True)


if __name__ == '__main__':
    main()
