"""The port's trainer, WIM fine-tuning and Poscod on a device mesh
(``joint_vae_tpu_torch/parallel``), held to the port's one-process run
and to the JAX package's mesh run.

Spawned gloo ranks (``tests/torch_mp_worker.py``) train a JAX-made job:

- on a (data 2, model 2) mesh of 4 ranks, 12 steps with the generator's
  noise equal the port's one-process steps within 1e-6 (per-step metrics,
  history, weights), each step runs one all-reduce over its 'data' group
  (plus the gradient norm's over 'model') and none over the world;
- with zero noise the same mesh run equals JAX's ``train_model`` on
  ``make_mesh(4, model_axis=2)`` within 1e-4;
- gradient clipping on the 'model' axis, and a multi-process run without
  a mesh refused;
- a BatchNorm trunk at data 2 steps as one process does;
- WIM ``finetune`` and Poscod on a (2, 2) mesh against the plain flow.

Tiny widths: INPUT_SHAPE (1, 6, 6), C=4, as tests/test_parallel.py.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.data.loaders import ArrayDataset as JArrayDataset
from joint_vae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.train.optimizers import OptimizerConfig as JOptimizerConfig
from joint_vae_tpu.train.trainer import train_model as jax_train_model
from joint_vae_tpu.utils.print_log import EpochOutput as JEpochOutput

from joint_vae_tpu_torch.models.cvnet import CVNet
from joint_vae_tpu_torch.parallel.mesh import make_mesh
from joint_vae_tpu_torch.save_load.from_jax import jax_to_state_dict
from joint_vae_tpu_torch.save_load.jobs import load_job
from joint_vae_tpu_torch.train import trainer
from joint_vae_tpu_torch.utils.print_log import EpochOutput

import torch_mp_worker as W
from torch_port_util import mesh_cfg as jax_cfg
from torch_port_util import jax_arrays, port_cfg

TRAIN = dict(n_train=64, epochs=3, batch_size=16)     # 3 x 4 = 12 steps


def _save_jax_job(d, cfg=None, opt=None):
    job = jjobs.new_job(cfg or jax_cfg(), opt or JOptimizerConfig(lr=3e-3),
                        key=jax.random.PRNGKey(0))
    jjobs.save_job(job, d)
    return job


@pytest.fixture(scope='module')
def job_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('trm') / 'job')
    _save_jax_job(d)
    return d


def one_process(job_dir, opt=None, n_train=64, epochs=3, batch_size=16,
                mesh=None, shape=(1, 6, 6), device_data=False):
    """The port's own run: per-step metrics, history and weights."""
    job = load_job(job_dir, device='cpu')
    if opt:
        job.opt_cfg = dataclasses.replace(job.opt_cfg, **opt)
    steps = []
    make = trainer.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(state, x, y, eps=None):
            state, m = step(state, x, y, eps)
            steps.append({k_: float(v) for k_, v in m.items()})
            return state, m
        return run
    trainer.make_train_step = recording
    try:
        trainer.train_model(job, W.dataset(n_train, 1, shape=shape), None,
                            epochs=epochs, batch_size=batch_size,
                            outputs=EpochOutput(stdout=False), seed=3,
                            final_test=False, final_ood=False, mesh=mesh,
                            device_data=device_data)
    finally:
        trainer.make_train_step = make
    w = {n: p.detach().numpy() for n, p in job.model.named_parameters()}
    return steps, job, w


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def _close_tree(got, want, tol, what=''):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_tree(got[k], want[k], tol, '{}/{}'.format(what, k))
    else:
        _close(got, want, tol, what)


@pytest.fixture(scope='module')
def mesh_run(job_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp('trm_run'))
    return W.launch('train', 4, out, job_dir=job_dir, model_axis=2, **TRAIN)


def test_mesh_trajectory_matches_one_process(job_dir, mesh_run):
    steps, job, w = one_process(job_dir)
    assert len(steps) == 12
    for r, res in enumerate(mesh_run):
        assert res['split'] == ['classifier.head.bias',
                                'classifier.head.weight', 'prior.mean',
                                'prior.var_param']
        got = [m for m, _ in res['steps']]
        assert len(got) == 12
        for i, (a, b) in enumerate(zip(got, steps)):
            _close_tree(a, b, 1e-6, 'rank {} step {}'.format(r, i))
        _close_tree(res['history'], {e: job.train_history[e]
                                     for e in (1, 2, 3)}, 1e-6, 'history')
        _close_tree(res['weights'], w, 1e-6, 'weights')


def test_one_data_all_reduce_per_step_and_none_over_the_world(mesh_run):
    for r, res in enumerate(mesh_run):
        data = [0, 2] if r % 2 == 0 else [1, 3]
        model = [0, 1] if r < 2 else [2, 3]
        for _, calls in res['steps']:
            assert calls.count(data) == 1, calls
            assert 'world' not in calls and [0, 1, 2, 3] not in calls
            # the gradient norm sums the class blocks over 'model'
            assert all(c in (data, model) for c in calls), calls


def test_mesh_trajectory_matches_jax_mesh(tmp_path, monkeypatch):
    """Zero noise on both sides (z = mu): the (2, 2) port run and JAX's
    train_model on make_mesh(4, model_axis=2) within 1e-4."""
    d = str(tmp_path / 'job')
    jjob = _save_jax_job(d)

    def jax_fake(key, mu, log_var, L, dist, sampled):
        return (jnp.broadcast_to(mu[None], (L + 1,) + mu.shape),
                jnp.zeros((L,) + mu.shape, mu.dtype))
    monkeypatch.setattr(jev, 'reparameterize', jax_fake)
    x, y = W.data(TRAIN['n_train'], 1)
    jax_train_model(jjob, JArrayDataset(x, y, 'blobs'), None, [],
                    epochs=TRAIN['epochs'], batch_size=TRAIN['batch_size'],
                    outputs=JEpochOutput(stdout=False), seed=3,
                    final_test=False, final_ood=False,
                    mesh=jax_make_mesh(4, model_axis=2))
    model = CVNet(port_cfg(jjob.model_cfg))
    want = jax_to_state_dict(model, jax_arrays(jjob.state))
    res = W.launch('train', 4, str(tmp_path / 'run'), job_dir=d,
                   model_axis=2, zero_noise=True, **TRAIN)
    for r in res:
        for e in (1, 2, 3):
            _close_tree(r['history'][e]['train_loss'],
                        jjob.train_history[e]['train_loss'], 1e-4,
                        'history {}'.format(e))
        for n, v in r['weights'].items():
            _close(v, want[n].numpy(), 1e-4, n)


def test_grad_clipping_on_the_model_axis(job_dir, tmp_path):
    """The clipping norm sums the class blocks over 'model': every rank
    clips by the one-process norm.  A multi-process run without a mesh is
    refused."""
    opt = {'grad_clipping': 0.5}
    steps, _, w = one_process(job_dir, opt=opt)
    assert any(m['grad_norm'] > 0.5 for m in steps)
    res = W.launch('train', 2, str(tmp_path), job_dir=job_dir, model_axis=2,
                   opt=opt, refuse=True, **TRAIN)
    for r in res:
        assert 'needs an explicit mesh' in r['refused']
        for i, ((a, _), b) in enumerate(zip(r['steps'], steps)):
            _close_tree(a, b, 1e-6, 'step {}'.format(i))
        _close_tree(r['weights'], w, 1e-6, 'weights')


def test_batchnorm_trunk_step_at_data2(tmp_path):
    """BatchNorm in training normalises with the global batch's
    statistics: a conv trunk with BatchNorm at data 2 steps as one process
    does (float32, within 1e-5).  SGD, not Adam: a conv bias ahead of a
    BatchNorm has a zero gradient in exact arithmetic, and Adam would
    scale its rounding noise up to full steps."""
    d = str(tmp_path / 'job')
    _save_jax_job(d, jax_cfg(input_shape=(1, 8, 8), features='[x3+1]8-8:2',
                             batch_norm='encoder'),
                  JOptimizerConfig(optim_type='sgd', lr=1e-2))
    kw = dict(n_train=64, epochs=1, batch_size=16, shape=(1, 8, 8))
    steps, job, w = one_process(d, n_train=64, epochs=1, batch_size=16,
                                shape=(1, 8, 8))
    res = W.launch('train', 2, str(tmp_path / 'run'), job_dir=d, **kw)
    bn = {n: b.numpy() for n, b in job.model.named_buffers()}
    for r in res:
        for i, ((a, _), b) in enumerate(zip(r['steps'], steps)):
            _close_tree(a, b, 1e-5, 'step {}'.format(i))
        _close_tree(r['weights'], w, 1e-5, 'weights')
        _close_tree(r['buffers'], bn, 1e-5, 'running statistics')


def test_world_of_one_mesh_trains_as_one_process(job_dir, monkeypatch):
    """A mesh of one rank without torch.distributed: the mesh step, no
    device-resident set, the one-process numbers."""
    built = []
    monkeypatch.setattr(trainer, 'DeviceDataset',
                        lambda *a, **k: built.append(1))
    steps, _, w = one_process(job_dir)
    msteps, _, mw = one_process(job_dir, mesh=make_mesh(device='cpu'),
                                device_data=True)
    assert not built
    for a, b in zip(msteps, steps):
        _close_tree(a, b, 1e-6)
    _close_tree(mw, w, 1e-6)


def test_shard_map_name_builds_the_mesh_step(job_dir):
    """``make_shard_map_train_step``, JAX's name, is
    ``make_train_step(mesh=)``: the same three steps to the bit."""
    from joint_vae_tpu_torch.parallel.mesh import ensure_placed
    from joint_vae_tpu_torch.parallel.shard_steps import (
        make_shard_map_train_step)
    from joint_vae_tpu_torch.parallel.sharded_data import (
        aligned_global_batch)
    from joint_vae_tpu_torch.train.steps import make_train_step
    mesh = make_mesh(device='cpu')
    x, y = W.data(48, 1)
    runs = []
    for make in (lambda m, o: make_train_step(m, o, mesh=mesh),
                 lambda m, o: make_shard_map_train_step(m, o, mesh)):
        job = load_job(job_dir, device='cpu')
        state = ensure_placed(job.state, mesh)
        step = make(state.model, job.opt_cfg)
        ms = []
        for i in range(3):
            xb, yb = aligned_global_batch(mesh, x[16 * i:16 * (i + 1)],
                                          y[16 * i:16 * (i + 1)])
            state, m = step(state, xb, yb)
            ms.append({k: float(v) for k, v in m.items()})
        runs.append((ms, {n: p.detach().numpy().copy()
                          for n, p in state.model.named_parameters()}))
    (ma, wa), (mb, wb) = runs
    assert ma == mb
    for n in wa:
        assert wa[n].tobytes() == wb[n].tobytes(), n


def test_wim_and_poscod_on_mesh_match_plain(job_dir, tmp_path):
    """WIM finetune and Poscod on a (2, 2) mesh against the plain flow
    (mirrors tests/test_ft_mesh.py): weights within 1e-5, OOD AUCs within
    one (in, out) pair, the llr scores within 1e-5."""
    from joint_vae_tpu_torch.ft.job import finetune, load_wim_job
    from joint_vae_tpu_torch.ft.poscod import PoscodJob
    plain = W.run_wim({'job_dir': job_dir}, None, load_wim_job, finetune,
                      PoscodJob, load_job)
    res = W.launch('wim', 4, str(tmp_path), job_dir=job_dir, model_axis=2)
    for r in res:
        _close_tree(r['weights'], plain['weights'], 1e-5, 'weights')
        for e, sets in plain['ood'].items():
            for s, ms in sets.items():
                for m, v in ms.items():
                    g = r['ood'][e][s][m]
                    assert abs(g['auc'] - v['auc']) <= 1 / (32 * 32) + 1e-7, m
                    _close(g['mean'], v['mean'], 1e-5, m)
        _close(r['llr'], plain['llr'], 1e-5, 'llr')
        _close_tree(r['head'], plain['head'], 1e-5, 'head')
