"""The traced run's device timeline: a ``torch.profiler`` session over a
short steady stretch after warm-up, marked by the benchmark's own span
``port_bench.window``, reduced to what the per-layer readers take.

- ``window_s``: the span's length; ``busy_s``: the union of every device
  operation's interval (kernels, copies, sets) inside it;
- ``kernels``: (name, seconds) of each kernel record inside the window;
- ``breakdown``: the device operations that took most time, summed by
  name, and the idle gaps of the timeline summed by what the host was
  doing at their middle (the benchmark's span around the call into the
  program, and the innermost host operation).
"""

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

WINDOW = 'port_bench.window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'python_function')
# the longest idle gaps named one by one; the rest are summed together
NAMED_GAPS = 400
# the port's kernel functions, by source (``csrc/<source>.cu``)
CONV_KERNELS = ('tc_conv_kernel', 'mma_conv_kernel', 'head_conv_kernel')
COMBINE_KERNELS = ('iws_combine_kernel', 'iws_combine_streamed_kernel')


class Session:
    """A profiler session and the window span inside it: ``open`` starts
    both, ``close`` ends them and reduces the trace (written to ``path``
    and deleted once read)."""

    def __init__(self, path: str, around: str = ''):
        self.path, self.around = path, around
        self.prof = None
        self.spans = []

    def open(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        # ``around``: the benchmark's span of a call into the program that
        # the window opens and closes inside
        self.spans = [torch.profiler.record_function(n)
                      for n in (WINDOW, self.around) if n]
        for s in self.spans:
            s.__enter__()

    def close(self) -> dict:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        for s in reversed(self.spans):
            s.__exit__(None, None, None)
        self.prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.remove(self.path)
        self.prof = None
        return reduce_events(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespace
    markers, template and arguments."""
    name = name.replace('(anonymous namespace)::', '')
    if name.startswith('void '):
        name = name[5:]
    for cut in ('<', '('):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    return name.strip()[:120]


def reduce_events(events: list) -> dict:
    spans = [e for e in events if e.get('name') == WINDOW
             and e.get('ph') == 'X' and e.get('cat') in HOST_CATS]
    if not spans:
        raise RuntimeError('the trace holds no {} span'.format(WINDOW))
    w0 = min(e['ts'] for e in spans)
    w1 = max(e['ts'] + e['dur'] for e in spans)
    dev, kernels = [], []
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') not in DEVICE_CATS:
            continue
        a, b = max(e['ts'], w0), min(e['ts'] + e['dur'], w1)
        if b <= a:
            continue
        dev.append((a, b))
        if e['cat'] == 'kernel':
            kernels.append((e['name'], (b - a) * 1e-6))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    ops: Dict[str, float] = {}
    for name, s in kernels:
        ops[short_name(name)] = ops.get(short_name(name), 0.0) + s
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') in ('gpu_memcpy', 'gpu_memset'):
            a, b = max(e['ts'], w0), min(e['ts'] + e['dur'], w1)
            if b > a:
                ops[e['name'][:120]] = ops.get(e['name'][:120], 0.0) + (b - a) * 1e-6
    host = [e for e in events if e.get('ph') == 'X'
            and e.get('cat') in HOST_CATS and e.get('name') != WINDOW]
    h0 = np.array([e['ts'] for e in host], np.float64)
    h1 = h0 + np.array([e['dur'] for e in host], np.float64)
    hd = h1 - h0
    ours = np.array([e['name'].startswith('port_bench.') for e in host], bool)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)
    gaps: Dict[str, float] = {}
    for i, (d, a, b) in enumerate(idle):
        if i >= NAMED_GAPS:
            key = 'the {} shorter gaps'.format(len(idle) - NAMED_GAPS)
        else:
            mid = 0.5 * (a + b)
            hit = np.nonzero((h0 <= mid) & (h1 >= mid))[0]
            inner = (host[hit[np.argmin(hd[hit])]]['name'] if len(hit)
                     else 'no host operation')
            mine = hit[ours[hit]]
            outer = (host[mine[np.argmax(hd[mine])]]['name'] if len(mine)
                     else 'outside the benchmark\'s spans')
            key = '{} / {}'.format(outer, inner)[:160]
        gaps[key] = gaps.get(key, 0.0) + d * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {'window_s': (w1 - w0) * 1e-6, 'busy_s': busy_s,
            'kernels': kernels,
            'breakdown': {'device_ops': top(ops), 'idle_gaps': top(gaps)}}


def kernel_seconds(kernels, functions) -> Tuple[float, int]:
    """Summed seconds and count of the kernel records whose name holds one
    of ``functions``."""
    hit = [s for name, s in kernels if any(f in name for f in functions)]
    return sum(hit), len(hit)
