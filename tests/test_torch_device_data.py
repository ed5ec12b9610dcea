"""The port's device-resident dataset (``train/device_data.py``) against the
JAX package's, on the CPU and the tiny flagship.

- ``DeviceDataset``: the storage it picks and its bytes equal JAX's on an
  8-bit float set, a float set that is not 8-bit, and a uint8 set; no
  float copy of an 8-bit set is made; the in-step normalisation is JAX's
  ``x * float32(1/255)``; a step's batch is gathered into its one input
  buffer;
- with JAX's permutation injected (``jax.random.permutation`` has no
  torch counterpart), the rows gathered in its order equal JAX's
  ``_shuffle``, and 12
  device-fed steps equal JAX's ``make_device_train_step`` within 1e-4
  (noise injected, L+1 layout, eps_0 = 0);
- ``train_epochs_on_device``, fused and per step: the history's keys and
  numbers within 1e-4 of JAX's run with the same ``fused``, a second call
  resuming from ``job.trained``, and a set smaller than a batch a no-op;
  the warmup ramps and ``log_every`` as JAX's, in both modes;
- ``train_model(device_data=True)`` against JAX's: history and weights
  within 1e-4; augmentation turns the device path off in both.
A run fed from the card is compared with a run fed from the card: 8-bit
data restored as k * (1/255) can differ by an ulp from the host's k/255.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import joint_vae_tpu.data.native as jnative
import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.data import loaders as jloaders
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.train import device_data as jdd
from joint_vae_tpu.train import optimizers as jopt
from joint_vae_tpu.train import trainer as jtrainer
from joint_vae_tpu.utils.print_log import EpochOutput as JEpochOutput

import joint_vae_tpu_torch.data.native as tnative
import joint_vae_tpu_torch.models.evaluate as tev
from joint_vae_tpu_torch.data import loaders as tloaders
from joint_vae_tpu_torch.models.cvnet import flagship_config
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.from_jax import state_dict_to_jax
from joint_vae_tpu_torch.train import device_data as tdd
from joint_vae_tpu_torch.train import trainer as ttrainer
from joint_vae_tpu_torch.train.graphs import Rows, StepGraph
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
from joint_vae_tpu_torch.train.state import create_train_state
from joint_vae_tpu_torch.train.steps import as_input
from joint_vae_tpu_torch.utils.print_log import EpochOutput

from torch_port_util import (close, inject_jax_eps, jax_arrays, make_eps,
                             port_model, port_sigma_state)

TOL = 1e-4
BATCH = 6


@pytest.fixture(autouse=True)
def numpy_loader(monkeypatch):
    monkeypatch.setattr(jnative, 'available', lambda: False)
    monkeypatch.setattr(tnative, 'available', lambda: False)


def jax_permutation(n, seed, epoch, device=None):
    """JAX's epoch permutation, fold_in(PRNGKey(seed), epoch), as the port's
    ``epoch_permutation`` returns one."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return torch.from_numpy(np.asarray(jax.random.permutation(key, n),
                                       np.int64))


@pytest.fixture
def jax_perm(monkeypatch):
    monkeypatch.setattr(tdd, 'epoch_permutation', jax_permutation)
    monkeypatch.setattr(ttrainer, 'epoch_permutation', jax_permutation)


def _inject_port_eps(monkeypatch, eps):
    """The port's evaluate draws ``eps`` (L+1, ...) as its latent noise."""
    real = tev.reparameterize

    def fake(mu, log_var, L, dist='gaussian', sampled=True, *, eps=None,
             generator=None):
        return real(mu, log_var, L, dist, sampled, eps=e, generator=generator)
    e = torch.from_numpy(eps)
    monkeypatch.setattr(tev, 'reparameterize', fake)


def _data(n, seed, kind='8bit'):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (n, 3, 8, 8)).astype(np.uint8)
    y = rng.integers(0, 4, n).astype(np.int32)
    if kind == 'uint8':
        return u8, y
    x = u8.astype(np.float32) / 255.0
    if kind == 'float':
        x = np.clip(x + np.float32(1e-3), 0, 1)
    return x, y


@pytest.mark.parametrize('kind', ['8bit', 'float', 'uint8'])
def test_storage_matches_jax(kind):
    x, y = _data(20, 1, kind)
    jd = jdd.DeviceDataset(jloaders.ArrayDataset(x, y, 's'))
    td = tdd.DeviceDataset(tloaders.ArrayDataset(x, y, 's'), device='cpu')
    want_u8 = jd.x.dtype == jnp.uint8
    assert (td.x.dtype == torch.uint8) == want_u8 == (kind != 'float')
    if not want_u8:
        assert td.x.dtype == torch.float32
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x))
    np.testing.assert_array_equal(td.y.numpy(), np.asarray(jd.y))
    assert td.y.dtype == torch.int32 and len(td) == td.n == 20


def test_normalisation_and_views():
    """Every uint8 value restores as JAX's step restores it; a step's batch
    is gathered from the set into the step's one input buffer (uint8 for an
    8-bit set: no float copy of it is ever made) and restored there."""
    k = np.arange(256, dtype=np.uint8).reshape(4, 1, 8, 8)
    want = np.asarray(jnp.asarray(k).astype(jnp.float32) * (1.0 / 255.0))
    got = as_input(torch.from_numpy(k))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # k * (1/255) is not k / 255 for every k: the ulp the docstring names
    assert not np.array_equal(want, k.astype(np.float32) / np.float32(255))

    x8, y = _data(24, 2, '8bit')
    t8 = tdd.DeviceDataset(tloaders.ArrayDataset(x8, y, 's'), device='cpu')
    assert t8.x.dtype == torch.uint8
    jd = jdd.DeviceDataset(jloaders.ArrayDataset(x8, y, 's'))
    perm = torch.randperm(24)
    jx, jy = jdd._shuffle(jd.x, jd.y, jnp.asarray(perm.numpy()))
    seen = []

    def body(state, x, y):
        seen.append((x.data_ptr(), x.dtype, as_input(x), y.clone()))
        return {'m': as_input(x).mean()}

    class State:
        generator = torch.Generator()
        opt_state = object()
        sigma_state = type('S', (), {'data': torch.zeros(1),
                                     'rmse': torch.zeros(())})()
    g = StepGraph(body, name='t')
    for i in range(3):
        rows = perm[i * BATCH:(i + 1) * BATCH]
        g(State, x=Rows(t8.x, rows), y=Rows(t8.y, rows))
    assert len({ptr for ptr, *_ in seen}) == 1
    for i, (_, dtype, xb, yb) in enumerate(seen):
        assert dtype == torch.uint8
        sl = slice(i * BATCH, (i + 1) * BATCH)
        np.testing.assert_array_equal(xb.numpy(), np.asarray(
            jx[sl].astype(jnp.float32) * (1.0 / 255.0)))
        np.testing.assert_array_equal(yb.numpy(), np.asarray(jy[sl]))


def test_shuffled_matches_jax_and_permutation_is_seeded():
    """The rows a device-fed epoch gathers in ``perm``'s order equal JAX's
    ``_shuffle`` of the set; the permutation is seeded by (seed, epoch)."""
    x, y = _data(30, 3)
    jd = jdd.DeviceDataset(jloaders.ArrayDataset(x, y, 's'))
    td = tdd.DeviceDataset(tloaders.ArrayDataset(x, y, 's'), device='cpu')
    perm = jax_permutation(30, 5, 2)
    jx, jy = jdd._shuffle(jd.x, jd.y, jnp.asarray(perm.numpy()))
    np.testing.assert_array_equal(Rows(td.x, perm).value().numpy(),
                                  np.asarray(jx))
    np.testing.assert_array_equal(Rows(td.y, perm).value().numpy(),
                                  np.asarray(jy))
    dev = torch.device('cpu')
    p1 = tdd.epoch_permutation(30, 5, 2, dev)
    assert torch.equal(p1, tdd.epoch_permutation(30, 5, 2, dev))
    assert not torch.equal(p1, tdd.epoch_permutation(30, 5, 3, dev))
    assert not torch.equal(p1, tdd.epoch_permutation(30, 6, 2, dev))
    assert torch.equal(torch.sort(p1).values, torch.arange(30))


def _jjob(opt=None, seed=0, **cfg):
    jcfg = dataclasses.replace(graft._flagship_cfg(tiny=True), **cfg)
    return jjobs.new_job(jcfg, opt or jopt.OptimizerConfig(lr=2e-3),
                         key=jax.random.PRNGKey(seed))


def test_device_steps_match_jax_over_12_steps(monkeypatch):
    jjob = _jjob()
    jcfg = jjob.model_cfg
    eps = make_eps((jcfg.latent_sampling + 1, BATCH, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    x, y = _data(12 * BATCH, 4)
    jd = jdd.DeviceDataset(jloaders.ArrayDataset(x, y, 's'))
    assert jd.x.dtype == jnp.uint8
    perm = jax_permutation(len(x), 1, 0)
    jx, jy = jdd._shuffle(jd.x, jd.y, jnp.asarray(perm.numpy()))
    jstep = jdd.make_device_train_step(
        jjob.model, jopt.build_optimizer(jjob.opt_cfg), BATCH)

    model = port_model(jcfg, jjob.state)
    state = create_train_state(model, OptimizerConfig(lr=2e-3),
                               sigma_state=port_sigma_state(jjob.state))
    td = tdd.DeviceDataset(tloaders.ArrayDataset(x, y, 's'), device='cpu')
    step = tdd.make_device_train_step(model, OptimizerConfig(lr=2e-3), BATCH)
    jst = jjob.state
    for i in range(12):
        jst, jm = jstep(jst, jx, jy, i)
        state, m = step(state, td.x, td.y, i, eps=torch.from_numpy(eps),
                        perm=perm)
        assert set(m) == set(jm)
        for k, v in jm.items():
            close(m[k], v, TOL, 'step {} {}'.format(i, k))
    got = state_dict_to_jax(model)
    for k, v in jax_arrays(jst).items():
        close(got[k], v, TOL, k)
    close(state.sigma_state.data, jst.sigma_state.data, TOL, 'sigma')


def _close_history(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        if isinstance(v, dict):
            _close_history(got[k], v, '{}/{}'.format(what, k))
        else:
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                       err_msg='{}/{}'.format(what, k))


@pytest.mark.parametrize('fused', [True, False])
def test_train_epochs_on_device_matches_jax(tmp_path, monkeypatch, jax_perm,
                                            fused):
    """Two calls of one epoch each (the second resumes from job.trained),
    over 4 batches of 6 with lr decay; then a set smaller than a batch."""
    jjob = _jjob(jopt.OptimizerConfig(lr=2e-3, lr_decay=0.3))
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    tjob = tjobs.load_job(d, device='cpu')
    jcfg = jjob.model_cfg
    eps = make_eps((jcfg.latent_sampling + 1, BATCH, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    _inject_port_eps(monkeypatch, eps)
    x, y = _data(4 * BATCH + 3, 5)
    for _ in range(2):
        want = jdd.train_epochs_on_device(
            jjob, jloaders.ArrayDataset(x, y, 's'), 1, BATCH, seed=7,
            fused=fused)
        got = tdd.train_epochs_on_device(
            tjob, tloaders.ArrayDataset(x, y, 's'), 1, BATCH, seed=7,
            fused=fused)
        assert set(got) == set(want)
        for k, v in want.items():
            close(got[k], v, TOL, k)
    assert tjob.trained == jjob.trained == 2
    for e in (1, 2):
        _close_history(tjob.train_history[e], jjob.train_history[e],
                       'history[{}]'.format(e))
    assert set(tjob.train_history[1]['train_loss']) == set(
        jcfg.loss_components) & set(want)
    got_w = state_dict_to_jax(tjob.model)
    for k, v in jax_arrays(jjob.state).items():
        close(got_w[k], v, TOL, k)
    assert tjob.state.step == int(jjob.state.step) == 8

    assert tdd.train_epochs_on_device(
        tjob, tloaders.ArrayDataset(x[:5], y[:5], 's'), 1, BATCH) == {}
    assert tjob.trained == 2 and tjob.state.step == 8


@pytest.mark.parametrize('fused', [True, False])
def test_train_epochs_on_device_warmup_matches_jax(tmp_path, monkeypatch,
                                                  jax_perm, capsys, fused):
    """The KL and cross-entropy warmup ramps over 3 epochs of 3 batches
    (weights 1/3, 2/3, 1 and 0, 1/2, 1), with JAX's meaning of
    (start, length); ``log_every=2`` prints epoch 2's total as JAX's
    does."""
    jjob = _jjob(jopt.OptimizerConfig(lr=2e-3))
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    tjob = tjobs.load_job(d, device='cpu')
    jcfg = jjob.model_cfg
    eps = make_eps((jcfg.latent_sampling + 1, BATCH, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    _inject_port_eps(monkeypatch, eps)
    x, y = _data(3 * BATCH, 8)
    kw = dict(warmup=(0, 2), warmup_gamma=(1, 1), seed=3, log_every=2,
              fused=fused)
    capsys.readouterr()
    want = jdd.train_epochs_on_device(
        jjob, jloaders.ArrayDataset(x, y, 's'), 3, BATCH, **kw)
    jout = capsys.readouterr().out.split()
    got = tdd.train_epochs_on_device(
        tjob, tloaders.ArrayDataset(x, y, 's'), 3, BATCH, **kw)
    tout = capsys.readouterr().out.split()
    assert tout[:3] == jout[:3] == ['epoch', '2:', 'total']
    assert len(tout) == len(jout) == 4
    np.testing.assert_allclose(float(tout[3]), float(jout[3]), atol=1e-4)
    assert set(got) == set(want)
    for k, v in want.items():
        close(got[k], v, TOL, k)
    for e in (1, 2, 3):
        _close_history(tjob.train_history[e], jjob.train_history[e],
                       'history[{}]'.format(e))
    got_w = state_dict_to_jax(tjob.model)
    for k, v in jax_arrays(jjob.state).items():
        close(got_w[k], v, TOL, k)


def test_train_model_device_data_matches_jax(tmp_path, monkeypatch,
                                             jax_perm):
    """train_model(device_data=True), 2 epochs with a validation split, a
    test set and warm-up ramps, z = mu (beta 0), against JAX's device-data
    trainer."""
    jjob = _jjob(jopt.OptimizerConfig(lr=2e-3, lr_decay=0.2), beta=0.0)
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    tjob = tjobs.load_job(d, device='cpu')

    def jax_fake(key, mu, log_var, L, dist, sampled):
        return (jnp.broadcast_to(mu[None], (L + 1,) + mu.shape),
                jnp.zeros((L,) + mu.shape, mu.dtype))

    def port_fake(mu, log_var, L, dist='gaussian', sampled=True, *, eps=None,
                  generator=None):
        return (mu[None].expand((L + 1,) + mu.shape),
                torch.zeros((L,) + mu.shape, dtype=mu.dtype))
    monkeypatch.setattr(jev, 'reparameterize', jax_fake)
    monkeypatch.setattr(tev, 'reparameterize', port_fake)
    x, y = _data(40, 6)
    xt, yt = _data(12, 7)
    kw = dict(epochs=2, batch_size=8, test_batch_size=12, validation=8,
              final_test=False, final_ood=False, seed=3, device_data=True,
              warmup=(0, 2), warmup_gamma=(0, 1))
    jtrainer.train_model(jjob, jloaders.ArrayDataset(x, y, 's'),
                         jloaders.ArrayDataset(xt, yt, 't'),
                         outputs=JEpochOutput(stdout=False), **kw)
    ttrainer.train_model(tjob, tloaders.ArrayDataset(x, y, 's'),
                         tloaders.ArrayDataset(xt, yt, 't'),
                         outputs=EpochOutput(stdout=False), **kw)
    assert tjob.train_history['epochs'] == 2
    for e in (1, 2):
        _close_history(tjob.train_history[e], jjob.train_history[e],
                       'history[{}]'.format(e))
    got = state_dict_to_jax(tjob.model)
    for k, v in jax_arrays(jjob.state).items():
        close(got[k], v, TOL, k)
    assert tjob.state.step == int(jjob.state.step) == 8


def test_augmentation_turns_device_data_off(monkeypatch):
    """Host augmentation needs the host loader: the trainer builds no
    DeviceDataset then (as the JAX trainer)."""
    built = []
    real = ttrainer.DeviceDataset
    monkeypatch.setattr(ttrainer, 'DeviceDataset',
                        lambda *a, **k: built.append(1) or real(*a, **k))
    x, y = _data(16, 8)
    for aug, want in (([], [1]), (['flip'], [])):
        built.clear()
        tjob = tjobs.new_job(flagship_config(tiny=True), seed=0,
                             device='cpu')
        ttrainer.train_model(tjob, tloaders.ArrayDataset(x, y, 's'), epochs=1,
                             batch_size=8, data_augmentation=aug,
                             final_test=False, device_data=True,
                             outputs=EpochOutput(stdout=False))
        assert built == want and tjob.state.step == 2
