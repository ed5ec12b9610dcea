#!/usr/bin/env python
"""Quality run of the PyTorch port: train the conv CVAE on the procedural
shapes32 set on the CUDA card, then measure classification accuracy and
OOD detection, as ``scripts/quality_run.py`` does for the JAX package
(the same configuration, optimizer, warmup, epochs, sets and methods).

    python scripts/torch_quality_run.py                  # float32, bfloat16
    python scripts/torch_quality_run.py --dtype bfloat16
    python scripts/torch_quality_run.py --device cpu --epochs 1 \\
        --train-size 512 --test-size 256 --out /tmp/q.json   # a rehearsal

Each dtype's record goes under its name into ``docs/QUALITY_TORCH.json``
(entries of other dtypes kept): the card's name and power limit, the
torch and CUDA versions, train seconds and images/s, the last epoch's
train losses, the accuracy per method and the best OOD AUROC per set,
beside the band the record is held to (``BAND``).  A run on the CPU
writes only where ``--out`` says.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch

from joint_vae_tpu_torch.data.loaders import get_dataset
from joint_vae_tpu_torch.evals.engines import accuracy, ood_detection_rates
from joint_vae_tpu_torch.models.cvnet import CVNetConfig
from joint_vae_tpu_torch.ops.priors import PriorConfig
from joint_vae_tpu_torch.ops.sigma import SigmaConfig
from joint_vae_tpu_torch.save_load.jobs import new_job
from joint_vae_tpu_torch.train.device_data import train_epochs_on_device
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig

OOD_SETS = ('uniform32', 'const32')
METHODS = ['iws', 'elbo', 'iws-2s', 'elbo-2s', 'zdist', 'soft']
# the band, fixed before the first run on the card against the JAX
# package's record (docs/QUALITY.json: esty 0.9975, best AUROC 1.0 on
# uniform32 and 0.9971 on const32); iws and closest are reported, not held
BAND = {'accuracy_esty': 0.99, 'auroc_uniform32': 0.99,
        'auroc_const32': 0.9871}


def config(compute_dtype: str) -> CVNetConfig:
    """``scripts/quality_run.py``'s configuration."""
    return CVNetConfig(
        input_shape=(3, 32, 32), num_labels=10, type='cvae',
        features='conv32', upsampler='deconv32',
        encoder=(512,), decoder=(512,), classifier=(),
        latent_dim=64, latent_sampling=1, test_latent_sampling=16,
        gamma=500.0, beta=0.03, sigma=SigmaConfig(value=0.15),
        prior=PriorConfig(dim=64, num_priors=10, init_mean=3.0,
                          learned_means=True),
        compute_dtype=compute_dtype)


def card() -> dict:
    if not torch.cuda.is_available():
        return {'device': 'cpu'}
    line = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    return {'device': torch.cuda.get_device_name(0), 'nvidia_smi': line,
            'count': torch.cuda.device_count()}


def _cut(ds, n):
    return ds.subset(slice(0, n)) if n else ds


def _launches(reset: bool = False) -> dict:
    """The kernels' launch counts (their wrappers count each launch)."""
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_dx)
    fns = {'same_grid_conv': same_grid_conv,
           'same_grid_conv_dx': same_grid_conv_dx, 'iws_combine': iws_combine}
    out = {k: f.launches for k, f in fns.items()}
    if reset:
        for f in fns.values():
            f.launches = 0
    return out


def run(dtype: str, epochs: int, device, train_size=None, test_size=None):
    tr, te = get_dataset('shapes32')
    tr, te = _cut(tr, train_size), _cut(te, test_size)
    oods = [_cut(get_dataset(n, splits=['test'], size=4000)[1], test_size)
            for n in OOD_SETS]
    job = new_job(config(dtype), OptimizerConfig(lr=3e-4), seed=0,
                  device=device)
    job.training_parameters['set'] = 'shapes32'
    sync = torch.cuda.synchronize if job.device.type == 'cuda' else (
        lambda: None)
    sync()
    _launches(reset=True)
    t0 = time.perf_counter()
    last = train_epochs_on_device(job, tr, epochs=epochs, batch_size=256,
                                  warmup=(0, 5), log_every=5)
    sync()
    train_s = time.perf_counter() - t0
    train_launches = _launches(reset=True)
    steps = epochs * (len(tr) // 256)
    print('{}: {} epochs, {} steps in {:.1f} s'.format(dtype, epochs, steps,
                                                       train_s), flush=True)
    t0 = time.perf_counter()
    acc = accuracy(job, te, batch_size=512, recording=False)
    res = ood_detection_rates(job, te, oods, batch_size=512, method=METHODS,
                              recording=False)
    sync()
    eval_s = time.perf_counter() - t0
    eval_launches = _launches(reset=True)
    best = {s: max((v['auc'], m) for m, v in ms.items())
            for s, ms in res.items()}
    met = {'accuracy_esty': acc['esty'] >= BAND['accuracy_esty']}
    met.update({'auroc_' + s: best[s][0] >= BAND['auroc_' + s]
                for s in OOD_SETS})
    return {
        'compute_dtype': dtype, 'epochs': epochs, 'batch_size': 256,
        'train_images': len(tr), 'test_images': len(te), 'steps': steps,
        'train_seconds': train_s,
        'train_images_per_s': steps * 256 / train_s,
        'eval_seconds': eval_s,
        'launches': {'train': train_launches, 'eval': eval_launches},
        'final_train': {k: float(v) for k, v in last.items()
                        if k in ('total', 'cross_y', 'mse', 'kl')},
        'accuracy': {m: float(v) for m, v in acc.items()},
        'ood_auroc_best': {s: {'auc': float(a), 'method': m}
                           for s, (a, m) in best.items()},
        'ood_auroc': {s: {m: float(v['auc']) for m, v in ms.items()}
                      for s, ms in res.items()},
        'band': BAND, 'band_met': met}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--dtype', nargs='+', default=['float32', 'bfloat16'],
                   choices=['float32', 'bfloat16'])
    p.add_argument('--epochs', type=int, default=30)
    p.add_argument('--device', default=None,
                   help="default the CUDA card; 'cpu' for a rehearsal")
    p.add_argument('--train-size', type=int, default=None)
    p.add_argument('--test-size', type=int, default=None)
    p.add_argument('--out', default=None,
                   help='record file (default docs/QUALITY_TORCH.json, on '
                        'the card only)')
    args = p.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit('no CUDA card: pass --device cpu (and --out)')
    on_card = args.device is None or str(args.device).startswith('cuda')
    out = args.out or (os.path.join(ROOT, 'docs', 'QUALITY_TORCH.json')
                       if on_card else None)
    build_s = None
    if on_card:
        from joint_vae_tpu_torch.ops import cuda_lib
        build_s = cuda_lib.build()       # before the clock: nvcc, once
    head = dict(card(), torch=torch.__version__, cuda=torch.version.cuda,
                kernel_build_seconds=build_s,
                dataset='shapes32 (procedural, 10 classes)',
                script='scripts/torch_quality_run.py',
                reference='docs/QUALITY.json (the JAX package)')
    print(json.dumps(head), flush=True)
    record = {}
    if out and os.path.exists(out):
        with open(out) as f:
            record = json.load(f)
    record.update(head)
    runs = record.setdefault('runs', {})
    for dtype in args.dtype:
        torch.manual_seed(0)
        r = run(dtype, args.epochs, args.device, args.train_size,
                args.test_size)
        runs[dtype] = dict(r, device=head['device'],
                           nvidia_smi=head.get('nvidia_smi'))
        print(json.dumps({dtype: r}), flush=True)
        if out:
            with open(out, 'w') as f:
                json.dump(record, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
