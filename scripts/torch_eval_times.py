#!/usr/bin/env python
"""Wall times of the port's evaluation entry points on the flagship, the
paths of ``chip_smoke.py``'s phases 6 and 8: the OOD engine over
cifar100's test set and three OOD sets at batch 512 (its compute tier),
first on a freshly loaded job, then again on the same job, and
``cli.test --compute rehard`` over the same four sets (each call loads
the job anew).  Each case runs graphed and eager where the checkout's
engines take ``graphed``, else eager alone.

    python scripts/torch_eval_times.py [--repeats 3] [--out FILE]
    PYTHONPATH=DIR python scripts/torch_eval_times.py    # DIR's port

The port on ``PYTHONPATH`` (another checkout's: an earlier commit's, to
compare two trees in one process each) is the one timed; the JSON line
names its checkout.  The modes run in turns (eager, graph, graph, eager,
...), after one untimed call of each mode, each call synchronised at
both ends.  The job and its store are written under ``--work``.  Prints
one JSON line.
"""

import argparse
import contextlib
import functools
import inspect
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.append(REPO)           # after PYTHONPATH

import numpy as np
import torch

OOD_SETS = ('cifar10', 'svhn', 'lsunc')
BATCH = 512
ENGINES = ('accuracy', 'ood_detection_rates',
           'misclassification_detection_rates')


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--repeats', type=int, default=3)
    p.add_argument('--work', default=os.path.join('jobs', 'eval_times'))
    p.add_argument('--out', default=None, help='also write the JSON here')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA card')
    import joint_vae_tpu_torch
    from joint_vae_tpu_torch.cli import test as test_cli
    from joint_vae_tpu_torch.data.loaders import get_dataset
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.evals import engines
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.ops import cuda_lib
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job, save_job
    set_float32_math()
    cuda_lib.build()

    shutil.rmtree(args.work, ignore_errors=True)
    job_dir = os.path.join(args.work, 'cifar100', 'flagship', '000000')
    job = new_job(flagship_config(), seed=0)
    job.training_parameters['set'] = 'cifar100'
    save_job(job, job_dir)
    del job
    _, testset = get_dataset('cifar100', splits=['test'])
    oodsets = [get_dataset(n, splits=['test'])[1] for n in OOD_SETS]
    graphs = 'graphed' in inspect.signature(
        engines.ood_detection_rates).parameters
    modes = (False, True) if graphs else (False,)
    order = [m for _ in range(args.repeats)
             for m in (modes + modes[::-1])][:len(modes) * args.repeats]

    def ood(job, mode):
        kw = {'graphed': mode} if graphs else {}
        engines.ood_detection_rates(job, testset, oodsets, batch_size=BATCH,
                                    from_where=('compute',),
                                    update_self_ood=False, recording=False,
                                    **kw)

    argv_cli = ['--job-dir', args.work, '--job', '0', '--compute', 'rehard',
                '--sets', 'cifar100'] + list(OOD_SETS) + ['-M', str(BATCH)]
    real = {n: getattr(test_cli, n) for n in ENGINES}

    def rehard(mode):
        if graphs:
            for n in ENGINES:
                setattr(test_cli, n, functools.partial(real[n],
                                                       graphed=mode))
        try:
            with open(os.devnull, 'w') as f, contextlib.redirect_stdout(f):
                if test_cli.main(argv_cli) != 0:
                    raise SystemExit('cli.test --compute rehard failed')
        finally:
            for n in ENGINES:
                setattr(test_cli, n, real[n])

    for mode in modes:              # the process's first calls, untimed
        ood(load_job(job_dir), mode)
    name = {False: 'eager', True: 'graph'}
    got = {c: {name[m]: [] for m in modes}
           for c in ('ood_first', 'ood_again', 'cli_test_rehard')}
    for mode in order:
        job = load_job(job_dir)
        got['ood_first'][name[mode]].append(_timed(lambda: ood(job, mode)))
        got['ood_again'][name[mode]].append(_timed(lambda: ood(job, mode)))
        del job
        got['cli_test_rehard'][name[mode]].append(
            _timed(lambda: rehard(mode)))
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    line = json.dumps({
        'port': os.path.dirname(os.path.dirname(joint_vae_tpu_torch.__file__)),
        'card': card, 'torch': torch.__version__, 'order': order,
        'images_per_call': len(testset) + sum(len(s) for s in oodsets),
        'ms': got,
        'median_ms': {c: {m: float(np.median(v)) for m, v in r.items()}
                      for c, r in got.items()}})
    print(line, flush=True)
    if args.out:
        with open(args.out, 'a') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
