#!/usr/bin/env python
"""Device time of the port's flagship train step, or of its Scorer batch,
under ``torch.profiler``: the graphed program beside its eager self.

    python scripts/torch_profile_step.py [--steps 10] [--batch 512] [--eval]
        [--dtype bfloat16|float32] [--eager] [--device cuda|cpu]
        [--tiny] [--geometry flagship|imagenet64|resnet] [--out FILE]
    PYTHONPATH=DIR python scripts/torch_profile_step.py ...   # DIR's port

The counterpart of ``scripts/profile_step.py`` (the JAX step under
``jax.profiler``), with the same flags plus ``--dtype`` (bfloat16 by
default, as there), ``--eager`` (the eager program alone), ``--device`` and
``--tiny`` (the tiny flagship: a rehearsal on the CPU, where no graph is
captured and no device time is recorded) and ``--geometry`` (the model:
the flagship by default, or ``imagenet64``, ``models/cvnet.py::
imagenet64_config``, which the port on the path must have, or ``resnet``,
the flagship with a resnet18 trunk, ``chip_smoke.py``'s ResNet
flagship).  Without ``--eval`` the
program is the host-fed train step (``train/steps.py``, bench.py's Adam
at lr 1e-4); with it, one ``Scorer`` batch at the flagship's test L and
the seven methods of ``bench.py``'s eval mode.

For each mode (eager, then graphed): 3 warm-up steps (a graph's warm-up,
capture and first replay), ``--steps`` timed steps (wall ms per step),
then two steps under the profiler, the first traced and dropped (a
session's first kernel records can be lost) and the second kept.  The
kept step's device time is grouped by kernel name and by span: the
innermost ``record_function`` span of the port (the same-grid conv's
``same_grid_conv_dx`` / ``_dw``, the trunk convs' ``trunk_conv_dw``), else the autograd node or the operator
that launched the kernel.  A replay runs its kernels without operators,
so each replayed kernel takes the span of the eager step's kernel at the
same position of the launch sequence (the capture is the eager body's
launches in order), or, where the sequences differ, the span its name
had most of the time in the eager step.  Prints one JSON line.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    # after PYTHONPATH, so that another checkout's port (an earlier
    # commit's, to time two trees one process each) can run instead
    sys.path.append(REPO)
METHODS = ('iws', 'elbo', 'zdist', 'mse', 'soft', 'iws-2s', 'elbo-2s')
SPANS = ('same_grid_conv_dx', 'same_grid_conv_dw', 'trunk_conv_dw')
WARMUP = 3
# the card idle around the kept step, so that the skew between the host's
# and the card's clocks puts none of its records outside its window
GAP_S = 0.05


def _kernel_group(name: str) -> str:
    from joint_vae_tpu_torch.ops.cuda_lib import source_of
    low = name.lower()
    if source_of(name) is not None:
        return source_of(name)
    if any(k in low for k in ('fprop', 'dgrad', 'wgrad', 'cudnn', 'conv')):
        return 'cudnn'
    if 'gemm' in low or 'gemv' in low:
        return 'cublas'
    if 'multi_tensor' in low or 'foreach' in low:
        return 'optimizer_foreach'
    if 'memcpy' in low or 'memset' in low:
        return 'copies'
    return 'elementwise_and_reductions'


def _eager_sequence(prof) -> list:
    """[(kernel name, span, ms)] in launch order, from the operators'
    tree: each kernel under the innermost port span, else the autograd
    node or the outermost operator that launched it."""
    seq = []

    def walk(ev, span, op):
        if ev.name in SPANS:
            span = ev.name
        elif ev.name.startswith('autograd::engine::evaluate_function'):
            op = ev.name.split(': ', 1)[-1]
        elif op is None and not ev.name.startswith('ProfilerStep'):
            op = ev.name
        for k in getattr(ev, 'kernels', ()):
            seq.append((k.name, span or op or 'none', k.duration / 1e3))
        for c in sorted(ev.cpu_children, key=lambda e: e.time_range.start):
            walk(c, span, op)
    tops = [ev for ev in prof.events()
            if ev.cpu_parent is None
            and ev.device_type != torch.autograd.DeviceType.CUDA]
    for ev in sorted(tops, key=lambda e: e.time_range.start):
        walk(ev, None, None)
    return seq


def _device_sequence(prof) -> list:
    """[(kernel name, ms)] of the device's records in start order (not
    the spans that the trace also draws on the device's timeline)."""
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(ev, 'is_user_annotation', False)
           and ev.name not in SPANS and not ev.name.startswith('ProfilerStep')
           and not ev.name.endswith('.launch')]
    evs.sort(key=lambda e: e.time_range.start)
    return [(ev.name, ev.time_range.elapsed_us() / 1e3) for ev in evs]


def _spans_of(device: list, eager: list) -> list:
    """A span for each device record: by position where the kernel names
    follow the eager step's launch order, else by the name's most
    frequent span there."""
    if [n for n, _ in device] == [n for n, _, _ in eager]:
        return [s for _, s, _ in eager]
    by_name = {}
    for n, s, _ in eager:
        by_name.setdefault(n, {}).setdefault(s, 0)
        by_name[n][s] += 1
    return [max(by_name[n], key=by_name[n].get) if n in by_name
            else 'unmatched' for n, _ in device]


def _profile(run, eager_seq=None) -> dict:
    from torch.profiler import ProfilerActivity, profile, schedule
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        _sync()
        prof.step()                     # the kept step's trace ends at exit
        time.sleep(GAP_S)
        t0 = time.perf_counter()
        run()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(GAP_S)
    eager = _eager_sequence(prof)
    # the device's own records; on the CPU the operators' kernels
    device = _device_sequence(prof) or [(n, ms) for n, _, ms in eager]
    ref = eager if eager_seq is None else eager_seq
    spans = _spans_of(device, ref)
    by_name, by_span = {}, {}
    for (name, ms), span in zip(device, spans):
        g = _kernel_group(name)
        by_name[g] = by_name.get(g, 0.0) + ms
        by_span[span] = by_span.get(span, 0.0) + ms
    busy = sum(ms for _, ms in device)
    top = {}
    for name, ms in device:
        top[name[:80]] = top.get(name[:80], 0.0) + ms
    return {'wall_ms': wall_ms, 'device_ms': busy,
            'device_busy_share': busy / wall_ms if cuda and wall_ms else None,
            'kernels': len(device), 'by_name_ms': by_name,
            'by_span_ms': dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            'top': sorted(top.items(), key=lambda kv: -kv[1])[:12],
            'span_assignment': ('launch order' if [n for n, _ in device]
                                == [n for n, _, _ in ref] else 'by name'),
            'sequence': eager if eager_seq is None else None}


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _program(args, graphed: bool, dev: torch.device):
    """The program as a function of no argument (a train step or a Scorer
    batch, ``graphed`` or not), and its graph."""
    from joint_vae_tpu_torch.models import cvnet
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    cfg = (cvnet.imagenet64_config(compute_dtype=args.dtype)
           if args.geometry == 'imagenet64' else
           cvnet.flagship_config(tiny=args.tiny, compute_dtype=args.dtype))
    if args.geometry == 'resnet':
        cfg = dataclasses.replace(cfg, features='resnet18')
    job = new_job(cfg, OptimizerConfig(lr=1e-4), seed=0, device=dev)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (args.batch,) + cfg.input_shape).astype(np.float32)
    if args.eval:
        from joint_vae_tpu_torch.serve import Scorer
        scorer = Scorer(job, methods=METHODS, graphed=graphed,
                        thresholds={m: float('-inf') for m in METHODS})
        return (lambda: scorer(x)), scorer.graph
    from joint_vae_tpu_torch.device import to_device
    from joint_vae_tpu_torch.train.steps import make_train_step
    step = make_train_step(job.model, job.opt_cfg, graphed=graphed)
    y = rng.integers(0, cfg.num_labels, args.batch)
    st = [job.state]

    def run():
        st[0], _ = step(st[0], to_device(x, dev), to_device(y, dev))
    return run, step.graph


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--steps', type=int, default=10)
    p.add_argument('--batch', type=int, default=512)
    p.add_argument('--eval', action='store_true',
                   help='a Scorer batch instead of a train step')
    p.add_argument('--dtype', default='bfloat16',
                   choices=['bfloat16', 'float32'])
    p.add_argument('--eager', action='store_true',
                   help='the eager program alone')
    p.add_argument('--device', default=None)
    p.add_argument('--tiny', action='store_true',
                   help='the tiny flagship (a rehearsal)')
    p.add_argument('--geometry', default='flagship',
                   choices=['flagship', 'imagenet64', 'resnet'])
    p.add_argument('--out', default=None, help='also write the JSON here')
    args = p.parse_args(argv)
    if args.tiny and args.geometry != 'flagship':
        p.error('--tiny is the tiny flagship')
    import joint_vae_tpu_torch
    root = os.path.dirname(os.path.dirname(joint_vae_tpu_torch.__file__))
    from joint_vae_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    result = {'program': 'scorer_batch' if args.eval else 'train_step',
              'geometry': args.geometry, 'batch': args.batch, 'dtype': args.dtype, 'root': root,
              'tiny': args.tiny, 'steps': args.steps,
              'device': (torch.cuda.get_device_name(dev)
                         if dev.type == 'cuda' else 'cpu'),
              'torch': torch.__version__, 'modes': {}}
    eager_seq = None
    for graphed in ((False,) if args.eager else (False, True)):
        run, graph = _program(args, graphed, dev)
        for _ in range(WARMUP):
            run()
        _sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        _sync()
        ms = (time.perf_counter() - t0) * 1e3 / max(args.steps, 1)
        prof = _profile(run, eager_seq if graphed else None)
        if not graphed:
            eager_seq = prof['sequence']
        prof.pop('sequence')
        prof['ms_per_step'] = ms
        prof['images_per_s'] = args.batch * 1e3 / ms
        prof['captures'] = [{k: c[k] for k in ('capture_s', 'kernel_nodes',
                                               'pool_bytes')}
                            for c in graph.captures]
        result['modes']['graph' if graphed else 'eager'] = prof
        del run, graph
        _sync()
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
