#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, at a cell's own
size on the card, from the same inputs a run of that seed makes:

- ``control``: the plain reference put in the program's place and
  computed in TF32 (the precision below the configuration's float32 with
  TF32 off), against the reference in float32;
- ``half_batch`` (training cells): the reference's steps with each batch's
  second half left out, the mean taken over the rest.

A step that leaves the state unchanged reads 1 on ``update_gap`` by its
definition and needs no run.

    python3 port_bench/calibrate.py --workload <name> --seeds 1 2 3 \\
        --kinds control half_batch

prints one JSON line per (seed, kind).  The program is not run: its own
readings are those of ``run.py``.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import compare, inputs           # noqa: E402
from harness.precision import tf32            # noqa: E402
from reference import loader as ref_loader    # noqa: E402
from reference import model as ref            # noqa: E402
from reference import steps as ref_steps      # noqa: E402


CARD_PULL = 8          # the trainer's metrics cadence on the card


def load(workload: str):
    with open(os.path.join(HERE, 'workloads', workload + '.json')) as f:
        wl = json.load(f)
    with open(os.path.join(HERE, 'configs', wl['config'] + '.json')) as f:
        return wl, json.load(f)


def _as_program(res: dict) -> dict:
    """Reference steps read as the program's are: the mean loss up to the
    first pull."""
    return {'loss': float(np.mean(res['losses'])),
            'first_grad': {k: v.cpu() for k, v in res['first_grad'].items()},
            'after': {k: v.cpu() for k, v in res['after'].items()}}


def train_readings(wl: dict, cfg: dict, seed: int, kinds, device,
                   set_size: int = 0) -> dict:
    """Each kind's training numbers at the cell's batch, over the steps the
    trainer runs to its first pull on the card (the weights after the
    compared steps), on the inputs of a run
    with ``seed`` (``set_size`` 0: the cell's set).  Prints each kind's
    worst leaves on standard error."""
    s = inputs.seeds(seed)
    B, n = wl['batch_size'], wl.get('metrics_every') or CARD_PULL
    W = inputs.make_weights(cfg, s['weights'], device)
    x, y = inputs.make_train_set(cfg, set_size or wl['set_size'], s['data'],
                                 device)
    flip, crop = ref_loader.augmentation(cfg['data_augmentation'],
                                         cfg['input_shape'][1])
    batches = [(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))
               for a, b in ref_loader.epoch_batches(x, y, B, s['loader'], 0,
                                                    n, flip, crop)]
    g = torch.Generator(device=device).manual_seed(s['noise'])
    noise = [inputs.latent_noise(g, cfg['latent_sampling'], B,
                                 cfg['latent_dim'], device) for _ in range(n)]
    after = compare.COMPARED_STEPS
    with tf32(False):
        want = ref_steps.adam_steps(W, cfg, batches, noise, after)
    out = {}
    for kind in kinds:
        if kind == 'control':
            with tf32(True):
                got = ref_steps.adam_steps(W, cfg, batches, noise, after)
        elif kind == 'half_batch':
            h = B // 2
            with tf32(False):
                got = ref_steps.adam_steps(
                    W, cfg, [(a[:h], b[:h]) for a, b in batches],
                    [e[:, :h] for e in noise], after)
        else:
            raise ValueError(kind)
        leaves = {}
        out[kind] = compare.train_gaps(_as_program(got), want, W, leaves)
        for k, v in leaves.items():
            worst = sorted(v.items(), key=lambda kv: -kv[1])[:3]
            print('{} seed {} worst {} leaves: {}'.format(kind, seed, k, worst),
                  file=sys.stderr)
    return out


def score_readings(wl: dict, cfg: dict, seed: int, kinds, device,
                   batches: int = 0) -> dict:
    """The control's scoring numbers on ``batches`` batches of the pool a
    run with ``seed`` makes (0: the cell's compared batches)."""
    s = inputs.seeds(seed)
    B, L, methods = wl['batch_size'], wl['L'], tuple(wl['methods'])
    W = inputs.make_weights(cfg, s['weights'], device)
    pool = inputs.make_pool(cfg, wl['pool_batches'], B, s['data'], device)
    eps = inputs.latent_noise(torch.Generator(device=device).manual_seed(0),
                              L, B, cfg['latent_dim'], device)
    out = {}
    for kind in kinds:
        if kind != 'control':
            raise ValueError(kind)
        worst = {}
        for b in range(batches or wl['compared_batches']):
            xb = torch.from_numpy(pool[b]).to(device)
            with torch.no_grad():
                with tf32(False):
                    want = ref.score_batch(W, cfg, xb, eps, methods,
                                           block=wl['reference_block'])
                with tf32(True):
                    low = ref.score_batch(W, cfg, xb, eps, methods,
                                          block=wl['reference_block'])
            got = {'label': low['label'].cpu().numpy(),
                   'confidence': low['confidence'].cpu().numpy(),
                   'scores': {m: v.cpu().numpy()
                              for m, v in low['scores'].items()}}
            thr = compare.thresholds_from(
                {m: v.cpu().numpy() for m, v in want['scores'].items()})
            inside = np.ones(B, bool)
            for m, t in thr.items():
                lo, hi = compare.bounds(t)
                inside &= (got['scores'][m] >= lo) & (got['scores'][m] <= hi)
            got['in_distribution'] = inside
            for k, v in compare.score_gaps(got, want, thr).items():
                worst[k] = max(worst.get(k, 0.0), v)
        out[kind] = worst
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--kinds', nargs='+', default=['control'])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('calibrate: no CUDA card', file=sys.stderr)
        return 2
    wl, cfg = load(args.workload)
    dev = torch.device('cuda', 0)
    fn = train_readings if wl['entry'] == 'train' else score_readings
    for seed in args.seeds:
        for kind, numbers in fn(wl, cfg, seed, args.kinds, dev).items():
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'kind': kind, 'numbers': numbers}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
