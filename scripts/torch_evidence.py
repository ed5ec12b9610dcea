"""What the PyTorch port's quality and evidence scripts share
(``scripts/torch_wim_quality.py``, ``torch_wim_study.py``,
``torch_poscod_quality.py``, ``torch_wim_inversion_study.py``, and in
part ``torch_quality_run.py`` and ``torch_reproduce_sota.py``): the
plain VAE of the JAX package's WIM and Poscod studies, pretraining on the
device and a fine-tune with their seconds, images/s and kernel launches,
the card's description, the command line they have in common and the
record file, one entry per run beside the head of the card and versions.

None of it imports jax or the JAX package.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch

from joint_vae_tpu_torch.models.cvnet import CVNetConfig
from joint_vae_tpu_torch.ops.priors import PriorConfig
from joint_vae_tpu_torch.ops.sigma import SigmaConfig
from joint_vae_tpu_torch.train.device_data import train_epochs_on_device

DTYPES = ('float32', 'bfloat16')
PRETRAIN_BATCH = 256


def vae_config(dtype: str, num_labels: int) -> CVNetConfig:
    """The JAX studies' plain VAE (``scripts/wim_quality.py:39-46``): conv32
    features, deconv32 upsampler, widths 512, K=64, beta 0.05, sigma 0.2,
    a gaussian prior."""
    return CVNetConfig(
        input_shape=(3, 32, 32), num_labels=num_labels, type='vae',
        features='conv32', upsampler='deconv32',
        encoder=(512,), decoder=(512,), latent_dim=64,
        latent_sampling=1, test_latent_sampling=16, gamma=0.0, beta=0.05,
        sigma=SigmaConfig(value=0.2), prior=PriorConfig(dim=64),
        compute_dtype=dtype)


def card() -> dict:
    """The card's name, ``nvidia-smi``'s name and power limit and the
    card count; ``{'device': 'cpu'}`` without a card."""
    if not torch.cuda.is_available():
        return {'device': 'cpu'}
    line = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    return {'device': torch.cuda.get_device_name(0), 'nvidia_smi': line,
            'count': torch.cuda.device_count()}


def launches() -> dict:
    """The kernels' launch counts (their wrappers count each launch)."""
    from joint_vae_tpu_torch.ops.iws import iws_combine
    from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                        same_grid_conv_dx)
    return {'same_grid_conv': same_grid_conv.launches,
            'same_grid_conv_dx': same_grid_conv_dx.launches,
            'iws_combine': iws_combine.launches}


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def cut(ds, n):
    """The first ``n`` items of a dataset (all of it for ``None``)."""
    return ds.subset(slice(0, n)) if n else ds


def steps_run() -> dict:
    """The step graphs' steps by how they ran (``train/graphs.py``): the
    wrappers count the launches of the eager and captured ones; a replay
    runs its graph's kernel nodes and calls no wrapper."""
    from joint_vae_tpu_torch.train.graphs import steps_run as run
    return dict(run)


def batches_run() -> dict:
    """The scoring graphs' batches by graph name and how they ran (as
    :func:`steps_run` counts steps)."""
    from joint_vae_tpu_torch.train.graphs import batches_run as run
    return {n: dict(r) for n, r in run.items()}


class Stopwatch:
    """Seconds, launches, steps and scored batches of a stretch of device
    work: synchronised at both ends, the launches, steps and batches
    counted as the difference of the wrappers' counts, of
    :func:`steps_run` and of :func:`batches_run` (which it leaves
    running)."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        sync(self.device)
        self.before = launches()
        self.before_steps = steps_run()
        self.before_batches = batches_run()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.seconds = time.perf_counter() - self.t0
        self.launches = {k: v - self.before[k] for k, v in launches().items()}
        self.steps_run = {k: v - self.before_steps[k]
                          for k, v in steps_run().items()}
        self.batches_run = {
            n: {k: v - self.before_batches.get(n, {}).get(k, 0)
                for k, v in r.items()} for n, r in batches_run().items()}


def pretrain(job, trainset, epochs: int, batch_size: int = PRETRAIN_BATCH,
             log_every: int = 10) -> dict:
    """``train_epochs_on_device`` as the JAX studies call it; returns its
    seconds, steps, images/s and launches."""
    with Stopwatch(job.device) as sw:
        train_epochs_on_device(job, trainset, epochs=epochs,
                               batch_size=batch_size, log_every=log_every)
    steps = epochs * (len(trainset) // batch_size)
    print('pretrained {} steps in {:.1f} s'.format(steps, sw.seconds),
          flush=True)
    return {'seconds': sw.seconds, 'steps': steps, 'batch_size': batch_size,
            'images_per_s': steps * batch_size / sw.seconds,
            'launches': sw.launches, 'steps_run': sw.steps_run}


class LoopClock:
    """``finetune``'s ``outputs``: the time of its last progress call,
    which follows the last metrics pull (a device sync), so that the
    loop's seconds stand apart from the post-tuning evaluation's."""

    def __init__(self):
        self.last = None
        self.steps = 0

    def results(self, i, per_epoch, epoch, epochs, **_):
        self.last = time.perf_counter()
        self.steps = per_epoch * epochs


def timed_finetune(finetune, wim, *args, batch_size: int,
                   moving_batch_size=None, **kw) -> dict:
    """``ft/job.py::finetune(wim, *args, ...)`` with its seconds: the
    loop's (its steps' images/s: the in-distribution and moving halves)
    and the post-tuning evaluation's, and the run's launches."""
    clock = LoopClock()
    with Stopwatch(wim.job.device) as sw:
        finetune(wim, *args, batch_size=batch_size,
                 moving_batch_size=moving_batch_size, outputs=clock, **kw)
    loop_s = clock.last - sw.t0
    images = clock.steps * (batch_size + (moving_batch_size or batch_size))
    return {'seconds': sw.seconds, 'loop_seconds': loop_s,
            'eval_seconds': sw.seconds - loop_s, 'steps': clock.steps,
            'images_per_s': images / loop_s, 'launches': sw.launches,
            'steps_run': sw.steps_run, 'batches_run': sw.batches_run}


def best(results: dict) -> dict:
    """{set: (best AUROC, its method)} of ``ood_detection_rates``'s or
    ``finetune``'s results."""
    return {s: max((v['auc'], m) for m, v in ms.items())
            for s, ms in results.items()}


def aurocs(results: dict, digits=4) -> dict:
    """{set: {method: AUROC}}, rounded as the JAX records round them."""
    return {s: {m: round(v['auc'], digits) for m, v in ms.items()}
            for s, ms in results.items()}


def skeleton(d):
    """A record's keys, nested: {key: skeleton of its value, or None}."""
    return ({k: skeleton(v) for k, v in d.items()} if isinstance(d, dict)
            else None)


def keys_unlike(run: dict, reference: dict,
                ignore=('round5_confirmation',)) -> list:
    """The keys of the JAX record ``reference`` whose nested keys differ
    in ``run`` (missing, or other sets, methods or conditions under
    them); ``ignore``: notes added to the JAX record by hand."""
    got = skeleton(run)
    return sorted(k for k, v in skeleton(reference).items()
                  if k not in ignore and got.get(k, 'missing') != v)


def parser(doc: str, *, dtypes=DTYPES, epochs: int = 20,
           ft_epochs=1, ft_size: int = 20000) -> argparse.ArgumentParser:
    """The flags every evidence script takes (each adds its own)."""
    p = argparse.ArgumentParser(
        description=doc.split('\n\n')[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--dtype', nargs='+', default=list(dtypes),
                   choices=list(DTYPES), help='one run per dtype, in order')
    p.add_argument('--device', default=None,
                   help="default the CUDA card; 'cpu' for a rehearsal")
    p.add_argument('--epochs', type=int, default=epochs,
                   help='pretraining epochs')
    p.add_argument('--train-size', type=int, default=None,
                   help='cap on the pretraining set')
    p.add_argument('--test-size', type=int, default=None,
                   help='cap on each evaluation set')
    p.add_argument('--ft-epochs', type=int, default=ft_epochs,
                   help='fine-tuning epochs')
    p.add_argument('--ft-size', type=int, default=ft_size,
                   help='fine-tuning training images')
    p.add_argument('--out', default=None,
                   help='record file (default under docs/, on the card '
                        'only; a CPU run writes only here)')
    p.add_argument('--seed', type=int, default=0,
                   help="added to every seed of the run (the models', the "
                        "alternate prior's, the fine-tunes' and heads'; 0: "
                        "the records'); a run of another seed is kept "
                        "under '<dtype> seed=<n>'")
    return p


def run_dtypes(args, default_out: str, script: str, reference: str,
               run_one, key=lambda dtype: dtype) -> dict:
    """Run ``run_one(dtype)`` for each ``args.dtype`` and keep its record
    under ``key(dtype)`` in the record file: ``args.out``, else
    ``docs/<default_out>`` on the card, else nowhere (a CPU run).  Other
    entries of an existing file are kept.  Returns the record."""
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit('no CUDA card: pass --device cpu (and --out)')
    on_card = args.device is None or str(args.device).startswith('cuda')
    out = args.out or (os.path.join(ROOT, 'docs', default_out)
                       if on_card else None)
    build_s = None
    if on_card:
        from joint_vae_tpu_torch.ops import cuda_lib
        build_s = cuda_lib.build()       # before the clock: nvcc, once
    head = dict(card(), torch=torch.__version__, cuda=torch.version.cuda,
                kernel_build_seconds=build_s, script=script,
                reference=reference)
    print(json.dumps(head), flush=True)
    record = {}
    if out and os.path.exists(out):
        with open(out) as f:
            record = json.load(f)
    record.update(head)
    runs = record.setdefault('runs', {})
    for dtype in args.dtype:
        torch.manual_seed(args.seed)
        t0 = time.perf_counter()
        r = run_one(dtype)
        r['seconds'] = time.perf_counter() - t0
        name = key(dtype) + (' seed={}'.format(args.seed) if args.seed else '')
        runs[name] = dict(r, compute_dtype=dtype, device=head['device'],
                                nvidia_smi=head.get('nvidia_smi'),
                                backend=torch.device(args.device or 'cuda').type)
        print(json.dumps({name: r}), flush=True)
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, 'w') as f:
                json.dump(record, f, indent=1)
    return record
