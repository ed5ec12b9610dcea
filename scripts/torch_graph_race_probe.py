#!/usr/bin/env python3
"""How often a scoring graph's replay right after another entry's eager
warm-up draws other numbers than the eager run, one ``race`` line a
variant:

    python3 scripts/torch_graph_race_probe.py [--reps 30]

The body and the batch order of ``tests/test_torch_graphs_cuda.py::
test_capture_under_queued_replays_draws_eager_noise`` (16 float32
products, then a draw from the graph's generator; a full batch's entry
replayed, a ragged tail's warmed up and later captured between them),
run ``--reps`` times graphed and once eagerly.  Each variant changes
``train/graphs.py::GraphRunner``: 'as_is' (the warm-ups on a side
stream, the captures on a capture stream that runs nothing else, the
caller's stream joined to it after a capture); 'sync_warm_up' (the card
synchronised before and after each eager warm-up); 'one_stream' (the
warm-ups and the captures on the side stream, the earlier design), alone
and with the warm-ups synchronised; 'warm_on_current' (the warm-up on the
current stream, the capture on the side stream); 'sync_capture' (the
card synchronised after each capture on the side stream), alone and with
the warm-up on the current stream; 'own_capture_stream' (the capture
stream apart), with the current stream joined to it after a capture or
the card synchronised then, and with the warm-ups synchronised too.
For every batch that differs: whether it holds a NaN, and which eager
batch it equals, if any.

Needs a CUDA card; exits nonzero without one.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(order, body, graphed, ScoreGraph, make_generator, dev):
    graph = ScoreGraph(body, name='race', graphed=graphed)
    gen = make_generator(dev, 0)
    outs = [graph(gen, x=x)['d'] for x in order]
    torch.cuda.synchronize()
    return [o.cpu() for o in outs]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--reps', type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('torch_graph_race_probe: no CUDA card')
    from joint_vae_tpu_torch.device import set_float32_math
    from joint_vae_tpu_torch.train import graphs
    from joint_vae_tpu_torch.train.state import make_generator
    set_float32_math()
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn(2048, 2048, device=dev, generator=g) / 48
    xa = torch.randn(4096, 2048, device=dev, generator=g)
    xb = torch.randn(1000, 2048, device=dev, generator=g)

    def body(generator, x):
        y = x
        for _ in range(16):
            y = torch.tanh(y @ w)
        return {'d': y[:, :1] * 0 + torch.randn(x.shape, device=x.device,
                                                generator=generator)}
    order = [xa] * 6 + [xb] + [xa] * 12 + [xb] + [xa] * 2
    eager = run(order, body, False, graphs.ScoreGraph, make_generator, dev)
    real_run, real_capture = graphs.GraphRunner._run, graphs.GraphRunner._capture

    capture_streams = {}

    def runner(warm_on_side=True, sync_warm=False, join_capture=False,
               own_capture_stream=False, sync_capture=False):
        """``GraphRunner._run`` with some things changed: the warm-up on
        the current stream; the card synchronised around each warm-up;
        the current stream made to wait for the capturing stream after a
        capture, or the card synchronised then; the capture on a stream
        of its own, which runs nothing else."""
        def _run(self, entry, generator, fn):
            dev = next(iter(entry.buffers.values())).device
            side = graphs._side_streams.get(dev)
            if side is None:
                side = graphs._side_streams[dev] = torch.cuda.Stream(dev)
            cap = side
            if own_capture_stream:
                cap = capture_streams.setdefault(dev, torch.cuda.Stream(dev))
            cur = torch.cuda.current_stream(dev)
            if not entry.warm:
                entry.warm = True
                self._count('eager')
                if sync_warm:
                    torch.cuda.synchronize()
                if not warm_on_side:
                    out = fn(entry.buffers)
                else:
                    side.wait_stream(cur)
                    with torch.cuda.stream(side):
                        out = fn(entry.buffers)
                    cur.wait_stream(side)
                    for t in graphs._outputs(out):
                        t.record_stream(cur)
                if sync_warm:
                    torch.cuda.synchronize()
                return out
            if entry.graph is None:
                if own_capture_stream:
                    cap.wait_stream(cur)
                self._capture(entry, generator, dev, cap, fn)
                if join_capture:
                    cur.wait_stream(cap)
                if sync_capture:
                    torch.cuda.synchronize()
            entry.graph.replay()
            self._count('replayed')
            return entry.out
        return _run

    variants = {
        'as_is': {},
        'one_stream': {'_run': runner()},
        'one_stream_sync_warm_up': {'_run': runner(sync_warm=True)},
        'sync_warm_up': {'_run': runner(sync_warm=True,
                                        own_capture_stream=True,
                                        join_capture=True)},
        'warm_on_current': {'_run': runner(warm_on_side=False)},
        'sync_capture': {'_run': runner(sync_capture=True)},
        'warm_on_current_sync_capture': {'_run': runner(
            warm_on_side=False, sync_capture=True)},
        'own_capture_stream_join': {'_run': runner(
            own_capture_stream=True, join_capture=True)},
        'own_capture_stream_sync_capture': {'_run': runner(
            own_capture_stream=True, sync_capture=True)},
        'own_capture_stream_sync_capture_sync_warm_up': {'_run': runner(
            own_capture_stream=True, sync_capture=True, sync_warm=True)}}
    print('probe', json.dumps({'torch': torch.__version__,
                               'card': torch.cuda.get_device_name(0),
                               'reps': args.reps}), flush=True)
    for name, patch in variants.items():
        for k, f in patch.items():
            setattr(graphs.GraphRunner, k, f)
        try:
            bad_runs, seen = 0, {}
            for _ in range(args.reps):
                got = run(order, body, True, graphs.ScoreGraph,
                          make_generator, dev)
                bad = [i for i, (e, h) in enumerate(zip(eager, got))
                       if not torch.equal(e, h)]
                bad_runs += bool(bad)
                for i in bad:
                    twin = [j for j, e in enumerate(eager)
                            if e.shape == got[i].shape
                            and torch.equal(e, got[i])]
                    key = '{} nan={} equals_eager={}'.format(
                        i, bool(torch.isnan(got[i]).any()), twin)
                    seen[key] = seen.get(key, 0) + 1
        finally:
            graphs.GraphRunner._run = real_run
            graphs.GraphRunner._capture = real_capture
        print('race', json.dumps({'variant': name, 'reps': args.reps,
                                  'runs_differing': bad_runs,
                                  'batches': seen}), flush=True)


if __name__ == '__main__':
    main()
