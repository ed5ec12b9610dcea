"""The step graphs (``train/graphs.py``) on the card: each graphed step
against its eager step from one state, bit for bit (every metric,
parameter, BatchNorm buffer, Adam moment, the sigma state, the
generator's state and the host counts), the launch counters, the
generator's draws, and a capture that fails raising.  Every test here
needs a CUDA card and skips without one; the file imports neither jax nor
the JAX package:

    python -m pytest tests/test_torch_graphs_cuda.py --noconftest -q
"""

import dataclasses
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
    torch.backends.cudnn.deterministic = True
    yield torch.device('cuda')
    torch.backends.cudnn.deterministic = False


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
