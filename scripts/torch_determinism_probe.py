#!/usr/bin/env python
"""Which operation makes the port's float32 training differ between runs?
One train-step gradient of a configuration at batch 256 (``--config``:
``scripts/torch_quality_run.py``'s shapes32, the flagship of
``models/cvnet.py::flagship_config``, or that flagship with a resnet18
trunk, ``chip_smoke.py``'s ResNet flagship), computed ``--repeats`` times from
one state, one batch and one noise seed on the CUDA card; prints one JSON
line: the parameters whose gradient differs between the repeats (in the
model's order: a difference in a layer's data gradient reaches every
parameter before it, one in its weight gradient only its own), a digest
of each gradient to compare two processes, and the warnings PyTorch gave.

    python scripts/torch_determinism_probe.py                    # the port's defaults
    python scripts/torch_determinism_probe.py --config flagship
    python scripts/torch_determinism_probe.py --config resnet
    python scripts/torch_determinism_probe.py --mode cudnn       # cudnn.deterministic
    python scripts/torch_determinism_probe.py --mode deterministic
    python scripts/torch_determinism_probe.py --dtype bfloat16
    PYTHONPATH=DIR python scripts/torch_determinism_probe.py     # DIR's port

``--mode deterministic`` is ``torch.use_deterministic_algorithms(True,
warn_only=True)``: each operation without a deterministic implementation
warns instead of raising.  A ``joint_vae_tpu_torch`` on ``PYTHONPATH``
(another checkout's: an earlier commit's, to compare two trees in one
process each) is the one probed; the JSON line names its checkout.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import warnings

import torch

BATCH = 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.append(REPO)           # after PYTHONPATH


def gradient(job, x, y) -> dict:
    """The train step's gradient (``train/steps.py``) for one noise seed."""
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.train.state import named_params
    params = named_params(job.model)
    out = evaluate(job.model, x, y, sigma_state=job.sigma_state, train=True,
                   with_beta=True, native_scores=True,
                   generator=torch.Generator(device=x.device).manual_seed(1))
    got = torch.autograd.grad(torch.mean(out.losses['total']),
                              list(params.values()), allow_unused=True)
    return {k: g for k, g in zip(params, got) if g is not None}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--mode', default='default',
                   choices=['default', 'cudnn', 'deterministic'])
    p.add_argument('--dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--config', default='shapes32',
                   choices=['shapes32', 'flagship', 'resnet'])
    p.add_argument('--repeats', type=int, default=4)
    args = p.parse_args(argv)
    import joint_vae_tpu_torch
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from scripts.torch_quality_run import config
    root = os.path.dirname(os.path.dirname(joint_vae_tpu_torch.__file__))
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA card')
    if args.mode == 'cudnn':
        torch.backends.cudnn.deterministic = True
    elif args.mode == 'deterministic':
        torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = (config(args.dtype) if args.config == 'shapes32'
           else flagship_config(compute_dtype=args.dtype))
    if args.config == 'resnet':
        cfg = dataclasses.replace(cfg, features='resnet18')
    job = new_job(cfg, seed=0)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((BATCH,) + job.model_cfg.input_shape, generator=g).cuda()
    y = torch.randint(0, job.model_cfg.num_labels, (BATCH,), generator=g).cuda()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        runs = [gradient(job, x, y) for _ in range(args.repeats)]
    differ = [k for k in runs[0]
              if not all(torch.equal(runs[0][k], r[k]) for r in runs[1:])]
    digest = {k: hashlib.sha1(v.float().cpu().numpy().tobytes()).hexdigest()[:12]
              for k, v in runs[0].items()}
    print(json.dumps({'mode': args.mode, 'dtype': args.dtype,
                      'config': args.config, 'root': root,
                      'device': torch.cuda.get_device_name(0),
                      'repeats': args.repeats, 'differ': differ,
                      'parameters': list(runs[0]), 'digest': digest,
                      'warnings': sorted({str(w.message).split('\n')[0]
                                          for w in caught})}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
