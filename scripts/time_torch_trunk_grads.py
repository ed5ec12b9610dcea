#!/usr/bin/env python3
"""Precision of the ResNet trunk's gradients on the card, with and without
the reference run's discrete choices imposed.

    python3 scripts/time_torch_trunk_grads.py

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
- ``card_cudnn``, ``card_cudnn_deterministic`` and ``card_no_cudnn``: the
  card in float32 through cuDNN (its default algorithms, then
  ``cudnn.deterministic``) and with cuDNN off (PyTorch's own CUDA
  convolutions);

each plain (its own ReLU masks and max-pool argmaxes) and ``_imposed``:
with the reference run's choices imposed (``tests/torch_choices.py``),
beside the number of elements where the imposed choice differs from the
run's own and the worst such element's distance to its tie (in units of
the rms of its op's input).  Prints the card's name and power limit, then
one JSON line per mode with the worst tensors.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

from joint_vae_tpu_torch.device import set_float32_math  # noqa: E402
from joint_vae_tpu_torch.models.resnet import ResNetFeatures  # noqa: E402
from torch_choices import Choices, moved_ulp  # noqa: E402

N = 64


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
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    set_float32_math()
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
        cases = [('cpu_f64_ulp', x_ulp, 'cpu', torch.float64),
                 ('cpu_f32', x, 'cpu', torch.float32),
                 ('card_cudnn', x, 'cuda', torch.float32),
                 ('card_cudnn_deterministic', x, 'cuda', torch.float32),
                 ('card_no_cudnn', x, 'cuda', torch.float32)]
        for name, xin, dev, dt in cases:
            torch.backends.cudnn.enabled = name != 'card_no_cudnn'
            torch.backends.cudnn.deterministic = name.endswith(
                'deterministic')
            try:
                runs[name], _ = grads(model, xin, w, dev, dt, train)
                runs[name + '_imposed'], s = grads(model, xin, w, dev, dt,
                                                   train, choices, True)
            finally:
                torch.backends.cudnn.enabled = True
                torch.backends.cudnn.deterministic = False
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
            'top_element_card_cudnn_imposed': sorted(
                elem['card_cudnn_imposed'].items(),
                key=lambda kv: -kv[1])[:4],
            'flips': flips,
            'top_card_cudnn': sorted(err['card_cudnn'].items(),
                                     key=lambda kv: -kv[1])[:6],
            'top_card_cudnn_imposed': sorted(
                err['card_cudnn_imposed'].items(),
                key=lambda kv: -kv[1])[:6]}),
              flush=True)


if __name__ == '__main__':
    main()
