#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on the card it is started
on:

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name: the cell in ``port_bench/workloads/<name>.json``,
its configuration in ``port_bench/configs/<config>.json``, its entry (the
call into ``joint_vae_tpu_torch`` that the window drives) in
``port_bench/entries/<entry>.py``, its metrics in the repository's
``BENCHMARK.json`` and each per-layer metric's reader in
``port_bench/metrics/<metric>.py``.  With ``--trace 0`` the run reports the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones from a
``torch.profiler`` trace of a short steady stretch.  Both check the
window's outputs against the plain reference (``port_bench/reference``)
and print each compared number beside its limit, last, on standard error
and under ``checks`` in the result, the last line of standard output.

Without a CUDA card, with fewer cards than the cell asks for, or when the
program's process holds JAX or the JAX package once the window has
closed, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse          # noqa: E402
import gc                # noqa: E402
import importlib.util    # noqa: E402
import json              # noqa: E402
import os                # noqa: E402
import sys               # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that the process must not hold, by top-level name
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'joint_vae_tpu')


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module of its own."""
    path = os.path.join(HERE, kind, name + '.py')
    spec = importlib.util.spec_from_file_location(
        'port_bench_{}_{}'.format(kind, name.replace('.', '_')), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    if not trace:
        return [m for m in bench['end_to_end']
                if workload in m.get('workloads', [workload])]
    e2e = {m['name'] for m in cell_metrics(bench, workload, False)}
    return [m for m in bench['per_layer']
            if workload in m.get('workloads', [workload])
            and m['moves'] in e2e]


def forbidden_modules() -> list:
    return sorted({n.split('.')[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What an entry gets: the cell, its configuration, the card, the
    run's seed and length, and the harness's services."""

    def __init__(self, args, workload: dict, cfg: dict, device):
        self.workload, self.cfg, self.device = workload, cfg, device
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)

    def trace_session(self, around: str = ''):
        from harness.trace import Session
        return Session(os.path.join(ROOT, 'build', 'port_bench',
                                    'trace-{}.json'.format(
                                        self.workload['name'])), around)

    def memory_peak(self) -> int:
        import torch
        if self.device.type != 'cuda':
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free_program(self) -> None:
        import torch
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference_precision(self):
        """The reference's float32 (TF32 off)."""
        from harness.precision import tf32
        return tf32(False)


def measure(args, device, workload=None, cfg=None) -> dict:
    """Run the cell once on ``device`` and return its result line (without
    the device's name); the caller has checked for the card.  ``workload``
    and ``cfg`` replace the cell's files (the tests' small twins)."""
    sys.path[:0] = [HERE, ROOT]
    bench = load_json(ROOT, 'BENCHMARK.json')
    wl = workload or load_json(HERE, 'workloads', args.workload + '.json')
    cfg = cfg or load_json(HERE, 'configs', wl['config'] + '.json')
    ctx = Context(args, wl, cfg, device)
    entry = load_module('entries', wl['entry'])
    build_s = 0.0
    if device.type == 'cuda':
        # a checkout's first run builds here (nvcc, g++); ``setup_s``
        # holds it, and the result line gives it apart
        from harness import program
        build_s = program.build_kernels()
    res = entry.run(ctx)
    from harness import compare
    checks, ok = compare.judge(res['numbers'], wl['limits'])
    ok = ok and res.get('compared_batches', 1) > 0
    metrics = {}
    if not args.trace:
        values = dict(res, setup_s=res['t0'] - T_START)
        for m in cell_metrics(bench, args.workload, False):
            metrics[m['name']] = {'value': float(values[m['name']]),
                                  'unit': m['unit']}
    else:
        from counts import flops
        from harness import peaks
        tr = res['traced']
        reading = {'cfg': cfg, 'workload': wl, 'result': res, 'trace': tr,
                   'flops': flops, 'peaks': peaks}
        for m in cell_metrics(bench, args.workload, True):
            v = load_module('metrics', m['name']).read(reading)
            if v is not None:
                metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    out = {'correct': bool(ok), 'attempted': int(res['attempted']),
           'failed': int(res['failed']), 'metrics': metrics,
           'device': {'platform': 'gpu', 'count': 1,
                      'memory_peak_bytes': int(res['memory_peak_bytes'])}}
    if args.trace:
        out['device'].update(busy_s=res['traced']['busy_s'],
                             window_s=res['traced']['window_s'])
        out['breakdown'] = res['traced']['breakdown']
    out['kernel_build_s'] = build_s
    out['numbers'] = res['numbers']
    out['checks'] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    wl = load_json(HERE, 'workloads', args.workload + '.json')
    # One intra-op thread in the process that runs the program: the default
    # pool (a thread a core) spins after each pinned copy, some 2.5 of the
    # machine's 8 cores in a training window, beside the batcher's threads
    # (PERF.md).  Set before torch is imported, which reads it once.
    os.environ['OMP_NUM_THREADS'] = '1'
    import torch
    if not torch.cuda.is_available():
        print('port_bench: no CUDA card is available; the benchmark runs '
              'only on one', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl['chips']:
        print('port_bench: {} needs {} cards, this machine has {}'.format(
            args.workload, wl['chips'], torch.cuda.device_count()),
            file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    out = measure(args, device)
    out['device']['kind'] = torch.cuda.get_device_name(device)
    found = forbidden_modules()
    if found:
        print('port_bench: the process holds {}, which the port must not '
              'load'.format(', '.join(found)), file=sys.stderr)
        return 3
    print('kernel build {!r} s of setup_s'.format(out['kernel_build_s']),
          file=sys.stderr)
    print('numbers {}'.format(json.dumps(out.pop('numbers'))), file=sys.stderr)
    for name, c in out['checks'].items():
        print('check {} {!r} limit {!r}'.format(name, c['value'], c['limit']),
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
