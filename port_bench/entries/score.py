"""A scoring cell: ``serve.py::Scorer.__call__`` of the program, one caller
in a closed loop, host float32 batches in and host results out.

Set-up builds the job from the seed's weights, calibrates the accept
bounds on a batch of the pool (each method's 5% quantile, a two-sided
method's 5% and 95% ones) with an eager scorer, and warms the graphed
scorer up: its first call runs eagerly, its second captures the graph.
The window then hands the pool's batches to the scorer in turn until
``--seconds`` have passed, timing each call from the host array handed
over to the host results returned.  Once the window has closed and the
program's state is freed, the reference scores a sample of the pool's
batches, drawn from the seed, and every call of those batches in the
window is compared with it.
"""

import time

import numpy as np
import torch

from harness import compare, inputs, program
from reference import model as ref


def run(ctx) -> dict:
    cfg, wl, dev = ctx.cfg, ctx.workload, ctx.device
    s = inputs.seeds(ctx.seed)
    methods, L, B = tuple(wl['methods']), wl['L'], wl['batch_size']
    W = inputs.make_weights(cfg, s['weights'], dev)
    job = program.build_job(cfg, W, dev, s['noise'])
    del W
    pool = inputs.make_pool(cfg, wl['pool_batches'], B, s['data'], dev)
    probe = program.Scorer(job, methods=methods, L=L, graphed=False,
                           thresholds={m: float('-inf') for m in methods})
    thresholds = compare.thresholds_from(probe(pool[0])['scores'])
    del probe
    scorer = program.Scorer(job, methods=methods, L=L, thresholds=thresholds)
    for b in range(2):                      # eager warm-up, then the capture
        scorer(pool[b])
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)

    answers, times = [], []
    session = ctx.trace_session() if ctx.trace else None
    calls = wl['trace_batches'] if ctx.trace else None
    t0 = time.perf_counter()
    if session is not None:
        session.open()
    i = 0
    while True:
        b = i % len(pool)
        with torch.profiler.record_function('port_bench.score_call'):
            t = time.perf_counter()
            out = scorer(pool[b])
            times.append(time.perf_counter() - t)
        answers.append((b, out))
        i += 1
        if calls is not None:
            if i >= calls:
                break
        elif time.perf_counter() - t0 >= ctx.seconds:
            break
    traced = session.close() if session is not None else None
    t1 = time.perf_counter()
    res = {'t0': t0, 'attempted': i, 'failed': 0, 'window_s': t1 - t0,
           'batches': i, 'images': i * B, 'traced': traced,
           'memory_peak_bytes': ctx.memory_peak()}
    del scorer, job
    ctx.free_program()

    # the reference on a sample of the pool's batches, drawn from the seed
    rng = np.random.default_rng(inputs.derive(ctx.seed, 9))
    k = min(wl['compared_batches'], len(pool))
    sample = sorted(rng.choice(len(pool), size=k, replace=False).tolist())
    W = inputs.make_weights(cfg, s['weights'], dev)
    eps = inputs.latent_noise(torch.Generator(device=dev).manual_seed(0), L,
                              B, cfg['latent_dim'], dev)
    worst = {}
    compared = 0
    for b in sample:
        with ctx.reference_precision(), torch.no_grad():
            want = ref.score_batch(W, cfg, torch.from_numpy(pool[b]).to(dev),
                                   eps, methods, block=wl['reference_block'])
        for bb, got in answers:
            if bb != b:
                continue
            compared += 1
            for name, v in compare.score_gaps(got, want, thresholds).items():
                worst[name] = max(worst.get(name, 0.0), v)
    res['numbers'] = worst
    res['compared_batches'] = compared
    res['score_images_per_s'] = res['images'] / res['window_s']
    res['score_batch_p95_ms'] = float(np.percentile(times, 95)) * 1e3
    return res
