"""The graphs (``train/graphs.py``) on the card: each graphed step
against its eager step from one state, bit for bit (every metric,
parameter, BatchNorm buffer, Adam moment, the sigma state, the
generator's state and the host counts), the launch counters, the
generator's draws, and a capture that fails raising; the Scorer's graph
against its eager self in both dtypes, its reseeded default noise, each
capture's kernel nodes by name; the OOD engine's graph with ODIN's
input gradient in it against its eager self; float32 training repeating
from a seed under the port's defaults (no ``cudnn.deterministic``); a
mesh step over NCCL on a world of one rank, graphed against eager with
its all-reduce inside the capture.
Every test here
needs a CUDA card and skips without one; the file imports neither jax nor
the JAX package:

    python -m pytest tests/test_torch_graphs_cuda.py --noconftest -q
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from joint_vae_tpu_torch.data.loaders import ArrayDataset
from joint_vae_tpu_torch.ft.wim import WIMJob
from joint_vae_tpu_torch.models.cvnet import flagship_config
from joint_vae_tpu_torch.ops import cuda_lib
from joint_vae_tpu_torch.save_load.jobs import new_job
from joint_vae_tpu_torch.train.device_data import train_epochs_on_device
from joint_vae_tpu_torch.train.graphs import (StepGraph, reset_steps_run,
                                              steps_run)
from joint_vae_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  build_optimizer,
                                                  set_learning_rate)
from joint_vae_tpu_torch.train.state import make_generator, named_params
from joint_vae_tpu_torch.train.steps import make_train_step

STEPS = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the step graphs capture on one')
    assert not torch.backends.cudnn.deterministic
    yield torch.device('cuda')


def _tensors(job) -> dict:
    o = job.state.opt_state
    out = {'p/' + k: v for k, v in job.model.state_dict().items()}
    for kind in ('mu', 'nu', 'trace'):
        out.update({kind + '/' + k: v for k, v in getattr(o, kind).items()})
    out['sigma'] = job.state.sigma_state.data
    out['rmse'] = job.state.sigma_state.rmse
    out['generator'] = job.state.generator.get_state()
    return {k: v.detach().cpu() for k, v in out.items()}


def _assert_same(eager: dict, graph: dict):
    assert set(eager) == set(graph)
    diff = [k for k in eager if not torch.equal(eager[k], graph[k])]
    assert not diff, diff


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (STEPS, n) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_labels, (STEPS, n))
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_train_step_graph_equals_eager(dtype, cuda_device):
    """4 steps across an epoch boundary (lr decay, warmup ramps): the graph
    warms up, captures, replays; the ramps and the lr move under it."""
    cfg = dataclasses.replace(flagship_config(tiny=True),
                              compute_dtype=dtype)
    opt = OptimizerConfig(lr=2e-3, lr_decay=0.5, weight_decay=1e-3,
                          grad_clipping=1.0)
    xs, ys = _batches(cfg, 16)
    got = {}
    for graphed in (False, True):
        job = new_job(cfg, opt, seed=1, device=cuda_device)
        step = make_train_step(job.model, opt, (0, 2), (1, 1),
                               graphed=graphed)
        before = cuda_lib.launch_counts()
        reset_steps_run()
        st, ms = job.state, []
        for i in range(STEPS):
            st.epoch = i // 2
            set_learning_rate(st.opt_state, opt.lr_at_epoch(st.epoch))
            st, m = step(st, xs[i].to(cuda_device), ys[i].to(cuda_device))
            ms.append(m.vector)
        torch.cuda.synchronize()
        after = cuda_lib.launch_counts()
        o = st.opt_state
        got[graphed] = (_tensors(job), torch.stack(ms).cpu(),
                        (o.count, o.adam_count, st.step),
                        {k: after[k] - before[k] for k in after}, step,
                        dict(steps_run))
    (te, me, ce, le, _, re), (tg, mg, cg, lg, step, rg) = (got[False],
                                                          got[True])
    _assert_same(te, tg)
    assert torch.equal(me, mg)
    assert ce == cg == (STEPS, STEPS, STEPS)
    # eager: every step's launches counted; graphed: the warm-up's and the
    # capture's, the replays' read from the graph's kernel nodes
    assert re == {'eager': STEPS, 'captured': 0, 'replayed': 0}
    assert rg == {'eager': 1, 'captured': 1, 'replayed': STEPS - 1}
    per_step = {k: v // STEPS for k, v in le.items()}
    assert per_step['same_grid_conv'] > 0 and per_step['same_grid_conv_dx'] > 0
    assert le == {k: STEPS * v for k, v in per_step.items()}
    assert lg == {k: 2 * v for k, v in per_step.items()}
    assert len(step.graph.captures) == 1
    cap = step.graph.captures[0]
    assert cap['kernel_nodes'] > 0 and cap['pool_bytes'] > 0
    assert cap['kernel_nodes_by_source'] == {
        'same_grid_conv': per_step['same_grid_conv']
        + per_step['same_grid_conv_dx'], 'iws_combine': 0}


@pytest.mark.cuda
def test_frozen_prior_graph_equals_eager(cuda_device):
    """``--freeze prior`` on means that thaw at epoch 1: the grad mask's
    thaw scalar is read on the card only, so the step captures, and the
    graph equals eager across the thaw."""
    cfg = flagship_config(tiny=True)
    cfg = dataclasses.replace(cfg, prior=dataclasses.replace(
        cfg.prior, freeze_means=1))
    opt = OptimizerConfig(lr=2e-3)
    xs, ys = _batches(cfg, 16, seed=6)
    got = {}
    for graphed in (False, True):
        job = new_job(cfg, opt, seed=1, device=cuda_device)
        step = make_train_step(job.model, opt, frozen_modules=('prior',),
                               graphed=graphed)
        st, ms = job.state, []
        for i in range(STEPS):
            st.epoch = i // 2
            st, m = step(st, xs[i].to(cuda_device), ys[i].to(cuda_device))
            ms.append(m.vector)
        torch.cuda.synchronize()
        got[graphed] = (_tensors(job), torch.stack(ms).cpu())
        assert len(step.graph.captures) == int(graphed)
    _assert_same(got[False][0], got[True][0])
    assert torch.equal(got[False][1], got[True][1])


@pytest.mark.cuda
@pytest.mark.parametrize('fused', [True, False])
def test_device_epochs_graph_equal_eager(fused, cuda_device):
    cfg = flagship_config(tiny=True)
    rng = np.random.default_rng(2)
    data = ArrayDataset(rng.integers(0, 256, (64,) + cfg.input_shape,
                                     dtype=np.uint8),
                        rng.integers(0, 4, 64).astype(np.int32), 's')
    got = {}
    for graphed in (False, True):
        job = new_job(cfg, OptimizerConfig(lr=2e-3, lr_decay=0.2), seed=3,
                      device=cuda_device)
        last = train_epochs_on_device(job, data, 2, 12, warmup=(0, 1),
                                      seed=5, fused=fused, graphed=graphed)
        torch.cuda.synchronize()
        got[graphed] = (_tensors(job), last, job.train_history)
    _assert_same(got[False][0], got[True][0])
    assert got[False][1] == got[True][1]
    assert got[False][2] == got[True][2]


@pytest.mark.cuda
def test_finetune_step_graph_equals_eager(cuda_device):
    cfg = flagship_config(tiny=True)
    xs, ys = _batches(cfg, 8, seed=4)
    xm, _ = _batches(cfg, 8, seed=5)
    got = {}
    for graphed in (False, True):
        job = new_job(cfg, OptimizerConfig(lr=1e-3), seed=2,
                      device=cuda_device)
        wim = WIMJob(job=job)
        wim.set_alternate_prior(distribution='gaussian', init_mean=8.0,
                                num_priors=1)
        tx = build_optimizer(job.opt_cfg)
        job.state.opt_state = tx.init(named_params(job.model))
        job.state.generator = make_generator(cuda_device, 3)
        step = wim.make_finetune_step(0.1, tx=tx, train_L=1, graphed=graphed)
        st, ms = job.state, []
        for i in range(STEPS):
            st, m = step(st, xs[i].to(cuda_device), ys[i].to(cuda_device),
                         xm[i].to(cuda_device))
            ms.append(m.vector)
        torch.cuda.synchronize()
        got[graphed] = (_tensors(job), torch.stack(ms).cpu(), st.step)
    _assert_same(got[False][0], got[True][0])
    assert torch.equal(got[False][1], got[True][1])
    assert got[False][2] == got[True][2] == STEPS


@pytest.mark.cuda
def test_generator_under_replay(cuda_device):
    """The registered generator: after an eager step, a capture and n
    replays its state equals n + 1 eager draws'; each replay draws what
    the eager step draws, and two replays draw differently."""
    class State:
        pass

    def body(state, x):
        return {'draw': (x + torch.randn(x.shape, device=x.device,
                                         generator=state.generator)).sum()}
    x = torch.ones(1024, device=cuda_device)
    draws = {}
    for graphed in (False, True):
        st = State()
        st.generator = make_generator(cuda_device, 11)
        st.opt_state = object()
        st.sigma_state = type('S', (), {'data': x, 'rmse': x})()
        g = StepGraph(body, name='draws', graphed=graphed)
        draws[graphed] = (torch.stack([g(st, x=x)['draw']
                                       for _ in range(STEPS)]).cpu(),
                          st.generator.get_state())
    assert torch.equal(draws[False][0], draws[True][0])
    assert torch.equal(draws[False][1], draws[True][1])
    assert len(set(draws[True][0].tolist())) == STEPS


_CAPTURE_FAILS = """
import torch
from joint_vae_tpu_torch.train.graphs import (StepGraph, reset_steps_run,
                                              steps_run)
from joint_vae_tpu_torch.train.state import make_generator
class State:
    pass
st = State()
st.generator = make_generator(torch.device('cuda'), 0)
st.opt_state = object()
x = torch.ones(8, device='cuda')
st.sigma_state = type('S', (), {'data': x, 'rmse': x})()
g = StepGraph(lambda state, x: {'v': x.sum() * float(x.max())},
              name='host_read')
g(st, x=x)
try:
    g(st, x=x)
    torch.cuda.synchronize()
except Exception as e:
    print('RAISED', type(e).__name__, g._entries and
          next(iter(g._entries.values())).graph is None)
else:
    print('NO RAISE')
"""


@pytest.mark.cuda
def test_capture_failure_raises(cuda_device):
    """A body that reads a value on the host cannot be captured: the step
    raises instead of running eagerly, and holds no graph.  In a child
    process: a failed capture leaves the process's default generator in
    its capture state."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', _CAPTURE_FAILS], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == 'RAISED', out.stdout
    assert out.stdout.split()[-1] == 'True', out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_scorer_graph_equals_eager(dtype, cuda_device):
    """One batch three times from a caller's generator (new noise each
    time), three times with the default noise (seed 0 every call: the
    registered generator reseeded, the same noise), a ragged batch three
    times: every output and the generator's state bit for bit against
    eager; one capture per generator and batch shape, each holding the
    conv's kernel nodes and one of the combine's, by name."""
    from joint_vae_tpu_torch.serve import Scorer
    cfg = dataclasses.replace(flagship_config(tiny=True),
                              compute_dtype=dtype)
    job = new_job(cfg, seed=1, device=cuda_device)
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (16,) + cfg.input_shape).astype(np.float32)
    tail = x[:5]
    methods = ('iws', 'elbo', 'zdist', 'soft', 'iws-2s')
    got = {}
    for graphed in (False, True):
        scorer = Scorer(job, methods=methods, graphed=graphed,
                        thresholds={m: 0.0 for m in methods})
        gen = make_generator(cuda_device, 5)
        before = cuda_lib.launch_counts()
        outs = ([scorer(x, generator=gen) for _ in range(3)]
                + [scorer(x) for _ in range(3)]
                + [scorer(tail) for _ in range(3)])
        after = cuda_lib.launch_counts()
        got[graphed] = (outs, gen.get_state().cpu(), scorer.graph.captures,
                        {k: after[k] - before[k] for k in after})
    for e, g in zip(got[False][0], got[True][0]):
        assert e['label'].tobytes() == g['label'].tobytes()
        assert e['confidence'].tobytes() == g['confidence'].tobytes()
        assert e['in_distribution'].tobytes() == \
            g['in_distribution'].tobytes()
        for m in methods:
            assert e['scores'][m].tobytes() == g['scores'][m].tobytes(), m
    assert torch.equal(got[False][1], got[True][1])
    # the default noise: the same every call
    for a, b in ((3, 4), (4, 5), (6, 7), (7, 8)):
        assert got[True][0][a]['scores']['iws'].tobytes() == \
            got[True][0][b]['scores']['iws'].tobytes()
    for a, b in ((0, 1), (1, 2)):
        assert got[True][0][a]['scores']['iws'].tobytes() != \
            got[True][0][b]['scores']['iws'].tobytes()
    caps = got[True][2]
    per_batch = {k: v // 9 for k, v in got[False][3].items()}
    assert per_batch['same_grid_conv'] > 0 and per_batch['iws_combine'] == 1
    assert len(caps) == 3          # gen; the default noise; its ragged batch
    for c in caps:
        assert c['kernel_nodes_by_source'] == {
            'same_grid_conv': per_batch['same_grid_conv'], 'iws_combine': 1}
    # graphed: each graph's warm-up and capture call the wrappers
    assert got[True][3] == {k: 6 * v for k, v in per_batch.items()}


@pytest.mark.cuda
def test_reseeded_generator_draws_the_same_noise(cuda_device):
    """A registered generator reseeded before each replay draws what a
    fresh generator of that seed draws, every call."""
    class State:
        pass

    def draw(generator, x):
        return {'d': x + torch.randn(x.shape, device=x.device,
                                     generator=generator)}
    from joint_vae_tpu_torch.train.graphs import ScoreGraph
    x = torch.zeros(4096, device=cuda_device)
    g = ScoreGraph(draw, name='reseeded')
    gen = make_generator(cuda_device, 0)
    outs = [g(gen.manual_seed(s), x=x)['d'] for s in (0, 0, 0, 9, 0)]
    fresh = {s: torch.randn(4096, device=cuda_device,
                            generator=make_generator(cuda_device, s))
             for s in (0, 9)}
    assert len(g.captures) == 1
    for o, s in zip(outs, (0, 0, 0, 9, 0)):
        assert torch.equal(o, fresh[s])


@pytest.mark.cuda
def test_float32_training_repeats_from_a_seed(cuda_device):
    """Two float32 flagship train steps at full width from one state and
    one seed, twice in one process under the port's defaults: every
    tensor and metric bit-equal (the 'conv' route's backward runs cuDNN's
    deterministic algorithms itself, ``models/conv.py``), the switch off
    again afterwards."""
    cfg = flagship_config()
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 256) + cfg.input_shape)
                         .astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.integers(0, cfg.num_labels, (2, 256))
                         ).to(cuda_device)
    runs = []
    for _ in range(2):
        job = new_job(cfg, OptimizerConfig(lr=1e-4), seed=4,
                      device=cuda_device)
        step = make_train_step(job.model, job.opt_cfg)
        st, ms = job.state, []
        for i in range(2):
            st, m = step(st, x[i], y[i])
            ms.append(m.vector)
        torch.cuda.synchronize()
        runs.append((_tensors(job), torch.stack(ms).cpu()))
        del job, step, st
    _assert_same(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.backends.cudnn.deterministic



@pytest.mark.cuda
def test_odin_engine_graph_equals_eager(cuda_device):
    """``ood_detection_rates`` with ODIN methods on a vib, its input
    gradient captured in the scoring graph (the conv kernel's dx and the
    float32 strided convs' deterministic backward among its nodes): two
    sets of two full batches and a ragged tail, from a caller's generator
    and then on the graph held on the job (the default noise), every
    score, ROC entry and the generator's state bit for bit against
    ``graphed=False``; each capture holding, by name, the kernel nodes
    of one eager batch's launches."""
    from joint_vae_tpu_torch.evals import engines
    from joint_vae_tpu_torch.ops.priors import PriorConfig
    from joint_vae_tpu_torch.save_load.jobs import load_job, save_job
    import tempfile
    cfg = dataclasses.replace(flagship_config(tiny=True), type='vib')
    cfg = dataclasses.replace(cfg, prior=PriorConfig(dim=cfg.latent_dim))
    methods = ['odin-1-0.0000', 'odin-1-0.0020', 'odin-10-0.0020',
               'baseline', 'logits']
    rng = np.random.default_rng(17)
    sets = [ArrayDataset(rng.uniform(0, 1, (n,) + cfg.input_shape)
                         .astype(np.float32),
                         rng.integers(0, cfg.num_labels, n), name)
            for n, name in ((40, 'test'), (40, 'ooda'))]
    kw = dict(batch_size=16, method=methods, from_where=('compute',),
              update_self_ood=False, recording=False)
    got = {}
    with tempfile.TemporaryDirectory() as d:
        save_job(new_job(cfg, seed=2, device=cuda_device), d)
        for graphed in (False, True):
            job = load_job(d, device=cuda_device)
            scores = []
            collect = engines._collect_scores

            def keep(*a, **k):
                out = collect(*a, **k)
                scores.append({m: v.cpu() for m, v in out.items()})
                return out
            engines._collect_scores = keep
            try:
                gen = make_generator(cuda_device, 6)
                before = cuda_lib.launch_counts()
                res = [engines.ood_detection_rates(
                    job, sets[0], sets[1:], generator=gen, graphed=graphed,
                    **kw)]
                after = cuda_lib.launch_counts()
                res.append(engines.ood_detection_rates(
                    job, sets[0], sets[1:], graphed=graphed, **kw))
            finally:
                engines._collect_scores = collect
            caps = [c for g in engines.held_score_graphs(job).values()
                    for c in g.captures]
            got[graphed] = (res, scores, gen.get_state().cpu(), caps,
                            {k: after[k] - before[k] for k in after})
    (res, scores, state, _, launched), graph = got[False], got[True]
    assert json.dumps(res, sort_keys=True) == json.dumps(graph[0],
                                                         sort_keys=True)
    assert torch.equal(state, graph[2])
    assert len(scores) == len(graph[1]) == 4
    for e, g in zip(scores, graph[1]):
        assert set(e) == set(g) == set(methods)
        for m in methods:
            assert torch.equal(e[m], g[m]), m
    per_batch = {k: v // 6 for k, v in launched.items()}
    assert per_batch['same_grid_conv_dx'] > 0
    # the caller's generator: a full batch and a tail captured; the held
    # graph's own generator: both again
    assert len(graph[3]) == 4
    for c in graph[3]:
        assert c['kernel_nodes_by_source'] == cuda_lib.by_source(per_batch)


def _jit_program(program: str, dev, graphed: bool):
    """One of the JAX package's last jitted programs on a fresh tiny
    flagship job, graphed or not: (its host outputs, the captures of the
    graphs it used, the wrappers' launches, the runs by graph name)."""
    from joint_vae_tpu_torch.cli import aggregate as agg_cli
    from joint_vae_tpu_torch.evals import sample
    from joint_vae_tpu_torch.ft import job as ft_job
    from joint_vae_tpu_torch.ft.poscod import PoscodJob
    from joint_vae_tpu_torch.train import trainer
    from joint_vae_tpu_torch.train.graphs import (batches_run,
                                                  held_score_graphs)
    import tempfile
    cfg = flagship_config(tiny=True)
    rng = np.random.default_rng(19)

    def data(n, name):
        return ArrayDataset(rng.uniform(0, 1, (n,) + cfg.input_shape)
                            .astype(np.float32),
                            rng.integers(0, cfg.num_labels, n), name)
    job = new_job(cfg, OptimizerConfig(lr=1e-3), seed=2, device=dev)
    ds = data(40, 'test')            # two full batches of 16, a tail of 8
    reset_steps_run()
    before, launched = cuda_lib.launch_counts(), None
    caps = []
    if program == 'mean_losses':
        # two epochs with train steps between: a graph that read stale
        # weights or sigma would differ from the eager calls; the
        # launches counted around the scoring calls alone
        step = make_train_step(job.model, job.opt_cfg, graphed=graphed)
        x, y = _batches(cfg, 16)
        out, launched = [], dict.fromkeys(before, 0)
        for epoch in range(2):
            for i in range(STEPS):
                job.state, _ = step(job.state, x[i].to(dev), y[i].to(dev))
            a = cuda_lib.launch_counts()
            out.append(trainer._mean_losses(job, ds, 16, epoch,
                                            graphed=graphed))
            b = cuda_lib.launch_counts()
            launched = {k: launched[k] + b[k] - a[k] for k in launched}
        caps = list(step.graph.captures)
    elif program == 'aggregate':
        out = [agg_cli._scores(job, ds, 16, s, graphed=graphed)
               for s in (0, 9)]
    elif program == 'poscod':
        pc = PoscodJob(job=job, graphed=graphed)
        pc.finetune(data(28, 'ind'), data(28, 'moving'), epochs=2,
                    batch_size=8, lr=1e-2, seed=1)
        out = ([pc.head[k].cpu().reshape(-1) for k in ('w', 'b')],
               [pc.llr_scores(ds, 16, seed=s) for s in (0, 2)])
    elif program == 'sample':
        out = [sample.select_correct_incorrect(job, ds, 30, batch_size=16,
                                               seed=s, graphed=graphed)
               for s in (3, 4)]
    else:
        wim = WIMJob(job=job)
        wim.set_alternate_prior(init_mean=8.0, num_priors=1, seed=3)
        gen = make_generator(dev, 5)
        with tempfile.TemporaryDirectory() as d:
            ft_job.record_latents(wim, [ds, data(12, 'other')], 16, gen, d,
                                  graphed=graphed)
            out = {}
            for f in sorted(os.listdir(d)):
                with open(os.path.join(d, f), 'rb') as fh:
                    out[f] = fh.read()
        out = (out, gen.get_state().cpu())
    torch.cuda.synchronize()
    if launched is None:
        after = cuda_lib.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
    caps += [c for g in held_score_graphs(job).values() for c in g.captures]
    return (out, caps, launched,
            {n: dict(r) for n, r in batches_run.items()}, dict(steps_run))


def _same_host(a, b, what=''):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same_host(a[k], b[k], '{}/{}'.format(what, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (u, v) in enumerate(zip(a, b)):
            _same_host(u, v, '{}[{}]'.format(what, i))
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, (what, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('program', ['mean_losses', 'aggregate', 'poscod',
                                     'sample', 'latents'])
def test_jit_program_graph_equals_eager(program, cuda_device):
    """The trainer's per-epoch losses (two epochs with graphed train steps
    between), ``cli.aggregate``'s scores, Poscod's head and scores, the
    sampling driver's scan and ``record_latents``' files, each graphed
    against ``graphed=False`` on the tiny flagship bit for bit; graphed,
    some batches replayed and each scoring capture holding, by name, the
    kernel nodes of one eager batch's launches."""
    eager = _jit_program(program, cuda_device, False)
    graph = _jit_program(program, cuda_device, True)
    _same_host(eager[0], graph[0], program)
    runs = {n: r for n, r in graph[3].items()}
    assert sum(r['replayed'] for r in runs.values()) > 0, runs
    assert all(r['captured'] == 0 and r['replayed'] == 0
               for r in eager[3].values())
    scored = sum(r['eager'] for r in eager[3].values())
    per_batch = {k: v // scored for k, v in eager[2].items()}
    assert per_batch['same_grid_conv'] > 0
    assert per_batch['same_grid_conv_dx'] == 0
    assert {k: v * scored for k, v in per_batch.items()} == eager[2]
    scoring = [c for c in graph[1] if c['name'] in runs]
    assert scoring
    for c in scoring:
        assert c['kernel_nodes_by_source'] == cuda_lib.by_source(
            per_batch), c['name']
    for c in graph[1]:
        if c['name'] == 'poscod_head_step':
            assert not any(c['kernel_nodes_by_source'].values())


@pytest.mark.cuda
def test_capture_under_queued_replays_draws_eager_noise(cuda_device):
    """A scoring graph's second entry (a ragged tail) captured while the
    first entry's replays are still queued on the card, nothing pulled in
    between, as the engines' held graphs run a set: every batch draws the
    noise an eager run draws from the same seed (each body is slow before
    its draw, so that the capture happens under a running replay)."""
    from joint_vae_tpu_torch.train.graphs import ScoreGraph
    g = torch.Generator(device=cuda_device).manual_seed(3)
    w = torch.randn(2048, 2048, device=cuda_device, generator=g) / 48
    xa = torch.randn(4096, 2048, device=cuda_device, generator=g)
    xb = torch.randn(1000, 2048, device=cuda_device, generator=g)

    def body(generator, x):
        y = x
        for _ in range(16):
            y = torch.tanh(y @ w)
        return {'d': y[:, :1] * 0 + torch.randn(x.shape, device=x.device,
                                                generator=generator)}
    order = [xa] * 6 + [xb] + [xa] * 12 + [xb] + [xa] * 2
    got = {}
    for graphed in (False, True):
        graph = ScoreGraph(body, name='race', graphed=graphed)
        gen = make_generator(cuda_device, 0)
        outs = [graph(gen, x=x)['d'] for x in order]
        torch.cuda.synchronize()
        got[graphed] = [o.cpu() for o in outs]
        assert graph.graphed == graphed
        if graphed:
            assert len(graph.captures) == 2
    bad = [i for i, (e, h) in enumerate(zip(got[False], got[True]))
           if not torch.equal(e, h)]
    assert not bad, bad


_MESH_STEP = """
import json, socket
import numpy as np
import torch
import torch.distributed as dist
from joint_vae_tpu_torch.models.cvnet import flagship_config
from joint_vae_tpu_torch.parallel.mesh import (distributed_init,
                                               ensure_placed, make_mesh)
from joint_vae_tpu_torch.save_load.jobs import new_job
from joint_vae_tpu_torch.train.graphs import reset_steps_run, steps_run
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
from joint_vae_tpu_torch.train.steps import make_train_step
with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
distributed_init('localhost:{}'.format(port), 1, 0, backend='nccl')
mesh = make_mesh()
cfg = flagship_config(tiny=True)
rng = np.random.default_rng(0)
xs = torch.from_numpy(rng.uniform(0, 1, (4, 16) + cfg.input_shape)
                      .astype(np.float32)).cuda()
ys = torch.from_numpy(rng.integers(0, cfg.num_labels, (4, 16))).cuda()
real, seen = dist.all_reduce, []
def counting(*a, **k):
    seen.append(torch.cuda.is_current_stream_capturing())
    return real(*a, **k)
dist.all_reduce = counting
got = {}
for graphed in (False, True):
    job = new_job(cfg, OptimizerConfig(lr=2e-3), seed=1)
    job.state = ensure_placed(job.state, mesh)
    step = make_train_step(job.model, job.opt_cfg, mesh=mesh,
                           graphed=graphed)
    reset_steps_run()
    del seen[:]
    st, ms = job.state, []
    for i in range(4):
        st, m = step(st, xs[i], ys[i])
        ms.append(m.vector)
    torch.cuda.synchronize()
    got[graphed] = {'metrics': torch.stack(ms).cpu(),
                    'params': {k: v.detach().cpu()
                               for k, v in job.model.state_dict().items()},
                    'steps_run': dict(steps_run), 'all_reduce': list(seen),
                    'captures': step.graph.captures}
    del job, step, st
e, g = got[False], got[True]
print(json.dumps({
    'graphed_default': make_train_step(new_job(cfg, seed=1).model,
                                       OptimizerConfig(),
                                       mesh=mesh).graph.graphed,
    'metrics_equal': torch.equal(e['metrics'], g['metrics']),
    'params_equal': all(torch.equal(e['params'][k], g['params'][k])
                        for k in e['params']),
    'steps_run': [e['steps_run'], g['steps_run']],
    'all_reduce': [e['all_reduce'], g['all_reduce']],
    'kernel_nodes_by_source': g['captures'][0]['kernel_nodes_by_source']}))
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_mesh_step_graph_equals_eager_over_nccl(cuda_device):
    """A world of one rank over NCCL: the mesh step graphs by default, and
    4 graphed steps equal 4 eager ones bit for bit; the step's all-reduce
    runs in the warm-up and inside the capture, none in a replay.  In a
    child process: the process group, and a failed capture's generator
    state, stay there."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', _MESH_STEP], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r['graphed_default'] is True
    assert r['metrics_equal'] and r['params_equal'], r
    assert r['steps_run'] == [{'eager': 4, 'captured': 0, 'replayed': 0},
                              {'eager': 1, 'captured': 1, 'replayed': 3}]
    assert r['all_reduce'] == [[False] * 4, [False, True]]
    assert r['kernel_nodes_by_source']['same_grid_conv'] > 0
