#!/usr/bin/env python3
"""The spread of the ResNet flagship's training gate on the card, over
seeds and repeats: what ``chip_smoke.py`` phase 10 holds its trunk convs'
weight gradients to (``TRUNK_WGRAD_TOL``) rests on these readings.

    python3 scripts/torch_trunk_gate_spread.py [--seeds 5] [--repeats 3]

Runs ``chip_smoke.train_gate`` on the ResNet flagship (``resnet18`` at
full width, batch 64, 3 graphed steps, each held to the CPU in float64
with the card's choices imposed) for init and data seeds (s, s + 4),
s = 1 .. ``--seeds`` (s = 1 is phase 10's), each ``--repeats`` times.
The trunk convs' bound is lifted so that every reading is reported: per
run the worst |card - cpu| / (|cpu| + rms(cpu)) over the trunk convs'
weight gradients and over every other tensor, per step, and the flips.
Every other bound of the gate stays; a run that fails one is reported
with its error.  Prints the card's name and power limit, one JSON line
per run, then a ``spread`` line with the worst readings.
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
                row.update({k: g[k] for k in (
                    'grad_worst', 'grad_worst_trunk_wgrad', 'update_worst',
                    'nu_worst', 'bn_stats_worst', 'loss_worst_rel_err',
                    'flips_total', 'flip_worst_distance')})
                row['trunk_wgrad_by_step'] = [
                    x['grad_err_over_abs_plus_rms']['worst_trunk_wgrad']
                    for x in g['rows']]
            except AssertionError as e:
                row['error'] = str(e)[:400]
            row['seconds'] = time.perf_counter() - t0
            runs.append(row)
            print('run', json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    done = [r for r in runs if 'error' not in r]
    print('spread', json.dumps({
        'runs': len(runs), 'failed': len(runs) - len(done),
        'trunk_wgrad_worst': max((r['grad_worst_trunk_wgrad']
                                  for r in done), default=None),
        'trunk_wgrad_least': min((r['grad_worst_trunk_wgrad']
                                  for r in done), default=None),
        'other_worst': max((r['grad_worst'] for r in done), default=None)}),
        flush=True)


if __name__ == '__main__':
    main()
