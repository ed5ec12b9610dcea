"""The step graphs' bodies (``train/graphs.py``) against the JAX package's
one-program steps, on the CPU and the tiny flagship.

On the CPU a step runs its graph's body eagerly on the graph's static
input buffers: the code that the card captures.  With the noise injected
(L+1 layout, eps_0 = 0) and JAX's permutation injected:

- the train step over 12 steps across three epochs (the learning rate
  decaying, the KL and cross-entropy ramps moving, the prior means thawing
  at epoch 1) against ``joint_vae_tpu.train.steps.make_train_step``:
  every metric, the parameters, the optimizer state and sigma within
  1e-4 (docs/PARITY.md's optimizer-trajectory tolerance);
- ``make_device_epoch_fn``'s epoch means and parameters against JAX's
  fused whole-epoch program over two epochs (1e-4);
- the WIM fine-tune step of ``make_finetune_step`` against JAX's
  ``finetune_batch`` over 12 steps (1e-4);
- the optimizer state, whose learning rate and Adam count the step reads
  from device scalars, written by the port and read by JAX and the other
  way round, bit-equal, and a step after the reload equal bit for bit to
  the same step without it;
- the host counts and every tensor of a graph-mode run equal to an eager
  run's; the static buffers reused; ``graph_mode`` on a mesh: NCCL's
  graphed by default, a mesh over gloo on a card eager and refusing a
  graph, the CPU's on the static buffers (the mesh steps themselves:
  ``tests/test_torch_mesh_graphs.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from joint_vae_tpu.ft import wim as jwim
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.save_load.checkpoint import flatten_pytree
from joint_vae_tpu.train import device_data as jdd
from joint_vae_tpu.train import optimizers as jopt
from joint_vae_tpu.train import steps as jsteps

import joint_vae_tpu_torch.models.evaluate as tev
from joint_vae_tpu_torch.ft import wim as twim
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.from_jax import (opt_state_to_jax,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.train import device_data as tdd
from joint_vae_tpu_torch.ops import cuda_lib
from joint_vae_tpu_torch.parallel.mesh import Mesh
from joint_vae_tpu_torch.train.graphs import PackedMetrics, Rows, StepGraph
from joint_vae_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  build_optimizer,
                                                  set_learning_rate)
from joint_vae_tpu_torch.train.state import (apply_grad_mask,
                                             create_train_state, grad_mask,
                                             named_params, thaw_factor)
from joint_vae_tpu_torch.train.steps import graph_mode, make_train_step

from torch_port_util import (close, inject_jax_eps, jax_arrays, make_eps,
                             port_model, port_sigma_state)

TOL = 1e-4
N = 6
EPOCHS, PER_EPOCH = 3, 4
OPT = dict(lr=2e-3, lr_decay=0.3, grad_clipping=40.0, weight_decay=1e-3)


def _tiny(**kw):
    jcfg = graft._flagship_cfg(tiny=True)
    jcfg = dataclasses.replace(
        jcfg, prior=dataclasses.replace(jcfg.prior, freeze_means=1))
    return dataclasses.replace(jcfg, **kw)


def _jjob(jcfg, opt, seed=0):
    return jjobs.new_job(jcfg, jopt.OptimizerConfig(**opt),
                         key=jax.random.PRNGKey(seed))


def _batches(jcfg, n, seed=5, size=N):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (size,) + jcfg.input_shape).astype(np.float32),
             rng.integers(0, jcfg.num_labels, size).astype(np.int32))
            for _ in range(n)]


def _jax_epoch(jst, epoch, opt_cfg):
    return jst.replace(epoch=jnp.asarray(epoch, jnp.int32),
                       opt_state=jopt.set_learning_rate(
                           jst.opt_state, opt_cfg.lr_at_epoch(epoch)))


def _close_state(state, jst, what):
    got = state_dict_to_jax(state.model)
    for k, v in jax_arrays(jst).items():
        close(got[k], v, TOL, '{} {}'.format(what, k))
    close(state.sigma_state.data, jst.sigma_state.data, TOL, what + ' sigma')
    close(state.sigma_state.rmse, jst.sigma_state.rmse, TOL, what + ' rmse')


def test_train_step_graph_body_matches_jax_across_epochs(monkeypatch):
    jcfg = _tiny()
    jjob = _jjob(jcfg, OPT)
    eps = make_eps((jcfg.latent_sampling + 1, N, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    ramps = ((0, 2), (1, 1))
    jstep = jsteps.make_train_step(
        jjob.model, jopt.build_optimizer(jjob.opt_cfg), *ramps, donate=False)
    model = port_model(jcfg, jjob.state)
    opt = OptimizerConfig(**OPT)
    state = create_train_state(model, opt,
                               sigma_state=port_sigma_state(jjob.state))
    step = make_train_step(model, opt, *ramps)
    assert step.graph.graphed
    jst = jjob.state
    batches = _batches(jcfg, EPOCHS * PER_EPOCH)
    for t, (x, y) in enumerate(batches):
        epoch = t // PER_EPOCH
        if t % PER_EPOCH == 0:
            jst = _jax_epoch(jst, epoch, jjob.opt_cfg)
            state.epoch = epoch
            set_learning_rate(state.opt_state, opt.lr_at_epoch(epoch))
        jst, jm = jstep(jst, jnp.asarray(x), jnp.asarray(y))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y),
                        eps=torch.from_numpy(eps))
        assert isinstance(m, PackedMetrics) and set(m) == set(jm)
        for k, v in jm.items():
            close(m[k], v, TOL, 'step {} {}'.format(t, k))
    assert state.step == int(jst.step) == EPOCHS * PER_EPOCH
    _close_state(state, jst, 'after 12 steps')
    got = opt_state_to_jax(model, opt, state.opt_state)
    want = flatten_pytree(jst.opt_state)
    assert set(got) == set(want)
    for k, v in want.items():
        close(got[k], v, TOL, k)
    # the step ran on its one set of static buffers, and captured nothing
    assert len(step.graph._entries) == 1 and step.graph.captures == []


def test_fused_epoch_matches_jax_fused_program(monkeypatch):
    """Two epochs of 4 batches: JAX's fused program shuffles with its key;
    the port's epoch takes the same permutation; the second epoch's ramps
    and learning rate moved."""
    jcfg = _tiny()
    jjob = _jjob(jcfg, OPT, seed=1)
    eps = make_eps((jcfg.latent_sampling + 1, N, jcfg.latent_dim), seed=3)
    inject_jax_eps(monkeypatch, eps)
    ramps = ((0, 1), (0, 2))
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (PER_EPOCH * N + 2,) + jcfg.input_shape
                     ).astype(np.uint8)
    y = rng.integers(0, jcfg.num_labels, len(x)).astype(np.int32)
    jfn = jdd.make_device_epoch_fn(jjob.model,
                                   jopt.build_optimizer(jjob.opt_cfg), N,
                                   PER_EPOCH, *ramps)
    model = port_model(jcfg, jjob.state)
    opt = OptimizerConfig(**OPT)
    state = create_train_state(model, opt,
                               sigma_state=port_sigma_state(jjob.state))
    tfn = tdd.make_device_epoch_fn(model, opt, N, PER_EPOCH, *ramps)
    real = tev.reparameterize

    def injected(mu, log_var, L, dist='gaussian', sampled=True, *, eps=None,
                 generator=None):
        return real(mu, log_var, L, dist, sampled,
                    eps=torch.from_numpy(noise), generator=generator)
    noise = eps
    monkeypatch.setattr(tev, 'reparameterize', injected)
    jst = jjob.state
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for epoch in range(2):
        key = jax.random.PRNGKey(10 + epoch)
        perm = torch.from_numpy(np.asarray(
            jax.random.permutation(key, len(x)), np.int64))
        jst = _jax_epoch(jst, epoch, jjob.opt_cfg)
        jst, jm = jfn(jst, jnp.asarray(x), jnp.asarray(y), key)
        state.epoch = epoch
        set_learning_rate(state.opt_state, opt.lr_at_epoch(epoch))
        state, m = tfn(state, tx, ty, perm)
        assert set(m) == set(jm)
        for k, v in jm.items():
            close(m[k], v, TOL, 'epoch {} {}'.format(epoch, k))
    assert state.step == int(jst.step) == 2 * PER_EPOCH
    _close_state(state, jst, 'after 2 fused epochs')


def test_finetune_step_graph_body_matches_jax(tmp_path, monkeypatch):
    jcfg = graft._flagship_cfg(tiny=True)
    opt = dict(optim_type='adam', lr=1e-3, weight_decay=1e-3)
    jjob = _jjob(jcfg, opt, seed=2)
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    tjob = tjobs.load_job(d, device='cpu')
    jw = jwim.WIMJob(job=jjob)
    jw.set_alternate_prior(key=jax.random.PRNGKey(3), init_mean=8.0,
                           num_priors=1, seed=3)
    tw = twim.WIMJob(job=tjob)
    tw.set_alternate_prior(init_mean=8.0, num_priors=1, seed=3)
    tw.set_alternate_prior_arrays({k: np.asarray(v) for k, v in
                                   jw.alternate_prior_params.items()})
    alpha = 0.1
    eps = make_eps((jcfg.latent_sampling + 1, N, jcfg.latent_dim), seed=9)
    inject_jax_eps(monkeypatch, eps)
    tx = jopt.build_optimizer(jjob.opt_cfg)
    jst = jjob.state.replace(opt_state=tx.init(jjob.state.params))
    jstep = jax.jit(lambda st, xi, yi, xm, k: jw.finetune_batch(
        st, xi, yi, xm, alpha, rng=k, tx=tx, train_L=jcfg.latent_sampling))
    ttx = build_optimizer(OptimizerConfig(**opt))
    tst = tjob.state
    tst.opt_state = ttx.init(named_params(tst.model))
    tst.sigma_state = port_sigma_state(jjob.state)
    step = tw.make_finetune_step(alpha, tx=ttx, train_L=jcfg.latent_sampling)
    assert step.graph.graphed
    rng = np.random.default_rng(4)
    for t in range(12):
        xi = rng.uniform(0, 1, (N,) + jcfg.input_shape).astype(np.float32)
        yi = rng.integers(0, jcfg.num_labels, N).astype(np.int32)
        xm = rng.uniform(0, 1, (N,) + jcfg.input_shape).astype(np.float32)
        jst, jm = jstep(jst, jnp.asarray(xi), jnp.asarray(yi),
                        jnp.asarray(xm), jax.random.PRNGKey(t))
        tst, tm = step(tst, torch.from_numpy(xi), torch.from_numpy(yi),
                       torch.from_numpy(xm), eps=torch.from_numpy(eps))
        assert set(tm) == set(jm)
        for k, v in jm.items():
            close(tm[k], v, TOL, 'step {} {}'.format(t, k))
    assert tst.step == int(jst.step) == 12
    _close_state(tst, jst, 'after 12 fine-tune steps')
    assert len(step.graph._entries) == 1


def _trained_port_job(tmp_path, steps=3):
    """A port job trained ``steps`` graph-mode steps (its optimizer's
    device scalars in use) and saved; -> (job, its dir, its step, the
    batch)."""
    jcfg = graft._flagship_cfg(tiny=True)
    jjob = _jjob(jcfg, OPT, seed=4)
    d = str(tmp_path / 'src')
    jjobs.save_job(jjob, d)
    job = tjobs.load_job(d, device='cpu')
    step = make_train_step(job.model, job.opt_cfg)
    (x, y), = _batches(jcfg, 1, seed=8)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    set_learning_rate(job.state.opt_state, job.opt_cfg.lr_at_epoch(1))
    for _ in range(steps):
        job.state, _ = step(job.state, *batch)
    out = str(tmp_path / 'trained')
    tjobs.save_job(job, out)
    return job, out, step, batch


def test_optimizer_checkpoint_bit_equal_through_both_packages(tmp_path):
    job, d, step, batch = _trained_port_job(tmp_path)
    o = job.state.opt_state
    assert (o.count, o.adam_count) == (3, 3)
    assert float(o.scalars.adam_t) == 3.0
    assert float(-o.scalars.neg_lr) == o.learning_rate
    mine = opt_state_to_jax(job.model, job.opt_cfg, o)
    jjob = jjobs.load_job(d)
    theirs = flatten_pytree(jjob.state.opt_state)
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(np.asarray(v), mine[k], err_msg=k)
        assert np.asarray(v).dtype == np.asarray(mine[k]).dtype, k
    back = str(tmp_path / 'back')
    jjobs.save_job(jjob, back)
    reloaded = tjobs.load_job(back, device='cpu')
    again = opt_state_to_jax(reloaded.model, reloaded.opt_cfg,
                             reloaded.state.opt_state)
    for k, v in mine.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    # the reloaded state's next step: its device scalars are filled from
    # the loaded counts, so it equals the original's next step bit for bit
    reloaded.state.generator.set_state(job.state.generator.get_state())
    _, m1 = step(job.state, *batch)
    step2 = make_train_step(reloaded.model, reloaded.opt_cfg)
    _, m2 = step2(reloaded.state, *batch)
    assert torch.equal(m1.vector, m2.vector)
    sd, sd2 = job.model.state_dict(), reloaded.model.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    assert reloaded.state.opt_state.adam_count == 4
    assert float(reloaded.state.opt_state.scalars.adam_t) == 4.0


def test_host_counts_and_tensors_equal_eager(tmp_path):
    """Graph mode (the static buffers) against eager over 5 steps across
    an epoch boundary: counts once per step, every tensor equal."""
    jcfg = _tiny()
    jjob = _jjob(jcfg, OPT, seed=5)
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    runs = {}
    batches = _batches(jcfg, 5, seed=9)
    for graphed in (True, False):
        job = tjobs.load_job(d, device='cpu')
        step = make_train_step(job.model, job.opt_cfg, (0, 2), (0, 1),
                               graphed=graphed)
        st, ms = job.state, []
        for t, (x, y) in enumerate(batches):
            st.epoch = t // 3
            set_learning_rate(st.opt_state, job.opt_cfg.lr_at_epoch(st.epoch))
            st, m = step(st, torch.from_numpy(x), torch.from_numpy(y))
            ms.append(m.vector)
        o = st.opt_state
        runs[graphed] = (job.model.state_dict(), torch.stack(ms),
                         (o.count, o.adam_count, st.step),
                         st.generator.get_state(), o.mu)
    g, e = runs[True], runs[False]
    assert g[2] == e[2] == (5, 5, 5)
    assert torch.equal(g[1], e[1]) and torch.equal(g[3], e[3])
    for k in e[0]:
        assert torch.equal(g[0][k], e[0][k]), k
    for k in e[4]:
        assert torch.equal(g[4][k], e[4][k]) and not g[4][k].requires_grad


def test_static_buffers_and_gathers():
    """The body reads the same static buffers each step (a copy of the
    input in them); a gather of rows fills them as index_select does; the
    metrics are views of one packed vector; the sums accumulate."""
    seen = []

    def body(state, x, y):
        seen.append((x.data_ptr(), x.clone()))
        return {'a': x.sum(), 'b': y.float().mean()}

    class State:
        generator = torch.Generator()
        opt_state = object()
        sigma_state = type('S', (), {'data': torch.zeros(1),
                                     'rmse': torch.zeros(())})()
    g = StepGraph(body, name='t')
    src = torch.arange(40.0).reshape(10, 4)
    ys = torch.arange(10)
    rows = torch.tensor([3, 1, 7])
    m1 = g(State, x=Rows(src, rows), y=Rows(ys, rows))
    m2 = g(State, x=src[:3] * 2, y=ys[:3])
    m3 = g(State, x=Rows(src, slice(2, 5)), y=Rows(ys, slice(2, 5)))
    assert seen[0][0] == seen[1][0] == seen[2][0]
    assert torch.equal(seen[0][1], src[rows])
    assert torch.equal(seen[2][1], src[2:5])
    assert list(m1) == ['a', 'b'] and m1['a'].data_ptr() == \
        m1.vector.data_ptr()
    assert torch.equal(g.sums, m1.vector + m2.vector + m3.vector)
    g.reset_sums()
    assert not g.sums.any()
    with pytest.raises(ValueError):
        graph_mode(True, _mesh_of('gloo', 'cuda'))
    assert graph_mode(None, _mesh_of('gloo', 'cuda')) is False
    assert graph_mode(None, _mesh_of('nccl', 'cuda')) is True
    assert graph_mode(None, None) is True


def test_frozen_prior_mask_reads_nothing_on_the_host():
    """The grad mask with the prior frozen while its means would thaw
    (``--freeze prior``): a captured step multiplies by the thaw scalar and
    reads no value of it on the host (a meta tensor holds none, so a host
    read raises), and the mask with the thaw as a tensor equals the mask
    with it as a float, frozen or not, before and after the thaw."""
    jcfg = _tiny()
    model = port_model(jcfg, _jjob(jcfg, OPT).state)
    frozen = grad_mask(model, ('prior',))
    assert frozen['prior.mean'] == 0.0
    assert grad_mask(model)['prior.mean'] == 1.0
    for mask in (frozen, grad_mask(model)):
        out = apply_grad_mask(model, {k: torch.ones(2, device='meta')
                                      for k in mask}, mask, 0,
                              torch.ones((), device='meta'))
        assert set(out) == set(mask)
        for epoch in (0, 1):
            ts = {k: torch.randn(3) for k in mask}
            want = apply_grad_mask(model, ts, mask, epoch)
            got = apply_grad_mask(model, ts, mask, epoch, torch.tensor(
                thaw_factor(model, epoch)))
            assert all(torch.equal(got[k], want[k]) for k in mask)


def test_kernel_sources_by_function_name():
    """A graph's kernel nodes are told apart by their functions' names
    (mangled or not): each of the port's __global__ functions maps to its
    CUDA source, any other kernel to none; the wrappers' counters sum by
    source (the conv's forward and dx launch the same kernels)."""
    import joint_vae_tpu_torch.ops.iws  # noqa: F401  (registers its counter)
    import joint_vae_tpu_torch.ops.same_grid_conv  # noqa: F401
    assert cuda_lib.source_of(
        '_Z14tc_conv_kernelIfLi64ELi2ELi1EEvPKT_S2_PS0_4Geom') == \
        'same_grid_conv'
    assert cuda_lib.source_of('void mma_conv_kernel<float, 64, 32, 2>('
                              'float const*, float const*, float*, MGeom)'
                              ) == 'same_grid_conv'
    assert cuda_lib.source_of('_Z16head_conv_kernelILi3ELi8EEvPKfS1_Pf5HGeom'
                              ) == 'same_grid_conv'
    assert cuda_lib.source_of('_Z18iws_combine_kernelPKfS0_') == 'iws_combine'
    assert cuda_lib.source_of('_ZN12_GLOBAL__N_127iws_combine_streamed_'
                              'kernelILb1EEEvPKfS2_S2_S2_S2_Pfiiiii') == \
        'iws_combine'
    for other in ('void at::native::vectorized_elementwise_kernel<4>()',
                  'sm90_xmma_fprop_implicit_gemm', 'ampere_sgemm_128x64_nn'):
        assert cuda_lib.source_of(other) is None
    counts = cuda_lib.launch_counts()
    assert set(counts) == {'same_grid_conv', 'same_grid_conv_dx',
                           'iws_combine'}
    assert cuda_lib.by_source({'same_grid_conv': 8, 'same_grid_conv_dx': 7,
                               'iws_combine': 0}) == {
        'same_grid_conv': 15, 'iws_combine': 0}


def _mesh_of(backend, device):
    """A one-rank mesh whose 'data' group is of ``backend`` (None: no
    groups) on ``device``: what ``graph_mode`` reads of a mesh."""
    return Mesh({'data': 1, 'model': 1},
                groups={'data': object()} if backend else None,
                device=torch.device(device), backend=backend)


@pytest.mark.parametrize('backend,device,default', [
    ('gloo', 'cuda', None), ('nccl', 'cuda', True), ('gloo', 'cpu', True),
    (None, 'cuda', True)])
def test_mesh_step_refuses_a_graph(backend, device, default):
    """``graph_mode`` on a mesh: gloo on a card stages its collectives
    through host memory, so its train and fine-tune steps refuse
    ``graphed=True`` and run eagerly by default; NCCL's graph by default,
    and so does a mesh on the CPU (the body on the graph's static
    buffers) or without groups; ``graphed=False`` is eager on every
    mesh."""
    jcfg = graft._flagship_cfg(tiny=True)
    jjob = _jjob(jcfg, {}, seed=6)
    model = port_model(jcfg, jjob.state)
    mesh = _mesh_of(backend, device)
    tx = build_optimizer(OptimizerConfig())
    if default is None:
        with pytest.raises(ValueError, match='gloo'):
            make_train_step(model, OptimizerConfig(), mesh=mesh,
                            graphed=True)
        with pytest.raises(ValueError, match='gloo'):
            twim.WIMJob(job=None).make_finetune_step(0.1, tx=tx, mesh=mesh,
                                                     graphed=True)
    else:
        assert make_train_step(model, OptimizerConfig(), mesh=mesh,
                               graphed=True).graph.graphed
    assert make_train_step(model, OptimizerConfig(),
                           mesh=mesh).graph.graphed is bool(default)
    assert twim.WIMJob(job=None).make_finetune_step(
        0.1, tx=tx, mesh=mesh).graph.graphed is bool(default)
    assert not make_train_step(model, OptimizerConfig(), mesh=mesh,
                               graphed=False).graph.graphed
