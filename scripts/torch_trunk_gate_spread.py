#!/usr/bin/env python3
"""The spread of the ResNet flagship's training gate on the card, over
seeds and repeats: the readings that ``chip_smoke.py`` phase 10 holds at
GRAD_TOL = 1e-4, its trunk convs' weight gradients at TRUNK_WGRAD_TOL.

    python3 scripts/torch_trunk_gate_spread.py [--seeds 5] [--repeats 3]

Runs ``chip_smoke.train_gate`` on the ResNet flagship (``resnet18`` at
full width, batch 64, 3 graphed steps, each held to the CPU in float64
with the card's choices imposed) for init and data seeds (s, s + 4),
s = 1 .. ``--seeds`` (s = 1 is phase 10's), each ``--repeats`` times.
The gradients' bounds are lifted so that every reading is reported (the
steps with a reading beyond GRAD_TOL are counted in ``beyond_grad_tol``):
per run the worst |card - cpu| / (|cpu| + rms(cpu)) over the trunk convs'
weight gradients (``models/resnet.py::TrunkConv``, the im2col product)
and over every other tensor, per step, each step's worst tensor, and
the flips.  Every other bound of the
gate stays; a run that fails one is reported with its error.  Prints the
card's name and power limit, one JSON line per run, then a ``spread``
line with the worst readings and, per seed, whether its repeats read the
same to the last digit.
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

READINGS = ('grad_worst', 'grad_worst_trunk_conv_weights', 'update_worst',
            'nu_worst', 'bn_stats_worst', 'loss_worst_rel_err',
            'flips_total', 'flip_worst_distance')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seeds', type=int, default=5)
    ap.add_argument('--repeats', type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('torch_trunk_gate_spread: no CUDA device')
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.ops import cuda_lib
    set_float32_math()
    print(chip_smoke.card_line(), flush=True)
    print('build seconds', round(cuda_lib.build(), 3), flush=True)
    bound, chip_smoke.GRAD_TOL = chip_smoke.GRAD_TOL, float('inf')
    trunk_bound = chip_smoke.TRUNK_WGRAD_TOL
    chip_smoke.TRUNK_WGRAD_TOL = float('inf')
    cfg = chip_smoke.resnet_config()
    runs = []
    for s in range(1, args.seeds + 1):
        for r in range(args.repeats):
            t0 = time.perf_counter()
            row = {'seeds': [s, s + 4], 'repeat': r}
            try:
                g = chip_smoke.train_gate(cfg, chip_smoke.RESNET_GATE_BATCH,
                                          (s, s + 4))
                row.update({k: g[k] for k in READINGS})
                grads = [x['grad_err_over_abs_plus_rms'] for x in g['rows']]
                row['trunk_conv_weights_by_step'] = [
                    x['worst_apart'] for x in grads]
                row['other_by_step'] = [x['worst_rest'] for x in grads]
                row['worst_tensor_by_step'] = [x['worst_name'] for x in grads]
                row['beyond_grad_tol'] = sum(x['worst'] > bound
                                             for x in grads)
            except AssertionError as e:
                row['error'] = str(e)[:400]
            row['seconds'] = time.perf_counter() - t0
            runs.append(row)
            print('run', json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    done = [r for r in runs if 'error' not in r]
    same = {}
    for s in range(1, args.seeds + 1):
        mine = [{k: v for k, v in r.items() if k not in ('repeat', 'seconds')}
                for r in runs if r['seeds'][0] == s]
        same[s] = all(m == mine[0] for m in mine[1:])
    print('spread', json.dumps({
        'runs': len(runs), 'failed': len(runs) - len(done),
        'grad_tol': bound, 'trunk_wgrad_tol': trunk_bound,
        'beyond_grad_tol': sum(r['beyond_grad_tol'] for r in done),
        'worst_tensors': sorted({n for r in done
                                 for n in r['worst_tensor_by_step']}),
        'trunk_conv_weights_worst': max(
            (r['grad_worst_trunk_conv_weights'] for r in done), default=None),
        'trunk_conv_weights_least': min(
            (r['grad_worst_trunk_conv_weights'] for r in done), default=None),
        'other_worst': max((max(r['other_by_step']) for r in done),
                           default=None),
        'repeats_identical_by_seed': same}), flush=True)


if __name__ == '__main__':
    main()
