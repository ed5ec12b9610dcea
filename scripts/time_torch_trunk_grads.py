#!/usr/bin/env python3
"""Precision of the ResNet trunk's gradients on the card.

    python3 scripts/time_torch_trunk_grads.py

``models/resnet.py::ResNetFeatures('resnet18')`` at full width, batch 64
of 32x32 inputs, random weights from a numpy seed, the loss a random
projection of its output: the gradient of every parameter, in training
mode (batch statistics) and in inference mode (running statistics),
computed on the CPU in float32, on the card through cuDNN and on the
card with cuDNN off (PyTorch's own CUDA convolutions), each held against
the CPU in float64 by its rms-relative error ||got - ref|| / ||ref||.
Prints the card's name and power limit, then one JSON line per mode
with the worst tensors.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from joint_vae_tpu_torch.device import set_float32_math  # noqa: E402
from joint_vae_tpu_torch.models.resnet import ResNetFeatures  # noqa: E402

N = 64


def grads(model, x, w, dev, dt, train):
    m = ResNetFeatures('resnet18')
    m.load_state_dict(model.state_dict())
    m = m.to(dev, dt)
    m.dtype = dt
    y = m(x.to(dev, dt), train, {}).reshape(N, -1)
    g = torch.autograd.grad((y * w.to(dev, dt)).sum(), list(m.parameters()))
    out = {k: v.cpu().double() for (k, _), v in zip(m.named_parameters(), g)}
    out['output'] = y.detach().cpu().double()
    return out


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
    x = torch.from_numpy(rng.uniform(0, 1, (N, 3, 32, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((N, 512)).astype(np.float32))
    for train in (True, False):
        ref = grads(model, x, w, 'cpu', torch.float64, train)
        runs = {'cpu_f32': grads(model, x, w, 'cpu', torch.float32, train),
                'card_cudnn': grads(model, x, w, 'cuda', torch.float32, train)}
        torch.backends.cudnn.enabled = False
        try:
            runs['card_no_cudnn'] = grads(model, x, w, 'cuda', torch.float32,
                                          train)
        finally:
            torch.backends.cudnn.enabled = True
        err = {r: {k: ((g[k] - ref[k]).norm() / ref[k].norm()).item()
                   for k in ref} for r, g in runs.items()}
        print(json.dumps({
            'mode': 'train' if train else 'inference', 'batch': N,
            'worst': {r: max(e.values()) for r, e in err.items()},
            'median': {r: float(np.median(list(e.values())))
                       for r, e in err.items()},
            'top_card_cudnn': sorted(err['card_cudnn'].items(),
                                     key=lambda kv: -kv[1])[:6]}),
              flush=True)


if __name__ == '__main__':
    main()
