"""The port's trainer and job store against the JAX package.

- ``train_model``: 2 epochs of the tiny flagship at ``beta=0,
  latent_sampling=1`` (z = mu) with a validation split, warmups and
  ``lr_decay``, from one job directory written by JAX: the history's
  losses and measures and the final parameters within 1e-4.  The IWAE
  weight's log q term still reads the drawn noise at z = mu, so both
  packages draw zeros there (the two RNGs differ);
- resume: a JAX-written job (optimizer.npz included) trains one more step
  in the port and in JAX, within 1e-4; a port-written job loads in JAX
  ``load_job`` with the same arrays, optimizer state included;
- the loader's batches equal the JAX package's numpy loader's (shuffle,
  hflip, crop), and so do ``get_batch`` and the validation split; the
  optimizer's config, format and injected learning rate, and the live
  epoch rows, match JAX's; the NaN guard marks the job 'derailed'; a run
  that would reach the unported evaluation engines raises; signal levels.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import joint_vae_tpu.data.native as jnative
import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.data import loaders as jloaders
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.save_load.checkpoint import flatten_pytree
from joint_vae_tpu.train import optimizers as jopt
from joint_vae_tpu.train import trainer as jtrainer
from joint_vae_tpu.utils.print_log import EpochOutput as JEpochOutput

import joint_vae_tpu_torch.models.evaluate as tev
from joint_vae_tpu_torch.data import loaders as tloaders
from joint_vae_tpu_torch.models.cvnet import flagship_config
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.from_jax import state_dict_to_jax
from joint_vae_tpu_torch.train import trainer as ttrainer
from joint_vae_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  format_optimizer)
from joint_vae_tpu_torch.utils.print_log import EpochOutput

from torch_port_util import close, jax_arrays

TOL = 1e-4


@pytest.fixture(autouse=True)
def numpy_loader(monkeypatch):
    """The JAX loader's numpy path (the one the port mirrors), not the
    native batcher."""
    monkeypatch.setattr(jnative, 'available', lambda: False)


@pytest.fixture
def zero_noise(monkeypatch):
    """Both packages sample with eps = 0 (z = mu): the IWAE weights' log q
    term reads eps even where the latent is not sampled."""
    import jax.numpy as jnp

    def jax_fake(key, mu, log_var, L, dist, sampled):
        return (jnp.broadcast_to(mu[None], (L + 1,) + mu.shape),
                jnp.zeros((L,) + mu.shape, mu.dtype))

    def port_fake(mu, log_var, L, dist='gaussian', sampled=True, *, eps=None,
                  generator=None):
        return (mu[None].expand((L + 1,) + mu.shape),
                torch.zeros((L,) + mu.shape, dtype=mu.dtype, device=mu.device))
    monkeypatch.setattr(jev, 'reparameterize', jax_fake)
    monkeypatch.setattr(tev, 'reparameterize', port_fake)


def _jcfg():
    return dataclasses.replace(graft._flagship_cfg(tiny=True), beta=0.0)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    return x, y


def _sets(n, seed, name='syn'):
    x, y = _data(n, seed)
    return (jloaders.ArrayDataset(x, y, name),
            tloaders.ArrayDataset(x, y, name))


def _close_tree(got, want, tol, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_tree(got[k], want[k], tol, '{}/{}'.format(what, k))
    else:
        close(np.asarray(got, np.float64), np.asarray(want, np.float64),
              tol, what)


TRAIN_KW = dict(batch_size=16, test_batch_size=12, validation=16,
                warmup=(0, 2), warmup_gamma=(0, 1), final_test=False,
                final_ood=False, seed=3)


def test_train_model_history_matches_jax(tmp_path, zero_noise):
    jcfg = _jcfg()
    jjob = jjobs.new_job(jcfg, jopt.OptimizerConfig(lr=2e-3, lr_decay=0.2),
                         key=jax.random.PRNGKey(0))
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    tjob = tjobs.load_job(d, device='cpu')
    assert tjob.opt_cfg == OptimizerConfig(lr=2e-3, lr_decay=0.2)
    (jtrain, ttrain), (jtest, ttest) = _sets(64, 1), _sets(24, 2)

    jtrainer.train_model(jjob, jtrain, jtest, epochs=2,
                         outputs=JEpochOutput(stdout=False), **TRAIN_KW)
    ttrainer.train_model(tjob, ttrain, ttest, epochs=2,
                         outputs=EpochOutput(stdout=False), **TRAIN_KW)
    assert tjob.train_history['epochs'] == jjob.train_history['epochs'] == 2
    for e in (1, 2):
        want, got = jjob.train_history[e], tjob.train_history[e]
        assert set(got) == set(want)
        _close_tree(got, want, TOL, 'history[{}]'.format(e))
    assert tjob.training_parameters['warmup'] == [0, 2]
    got = state_dict_to_jax(tjob.model)
    for k, v in jax_arrays(jjob.state).items():
        close(got[k], v, TOL, k)
    assert tjob.state.step == int(jjob.state.step) == 6


def test_jax_job_resumes_in_port(tmp_path, zero_noise):
    """One epoch of one step in JAX, saved; both packages load the job and
    train one more step: the port's step matches JAX's next one."""
    jcfg = _jcfg()
    opt = jopt.OptimizerConfig(lr=2e-3, grad_clipping=20.0, weight_decay=1e-3)
    jjob = jjobs.new_job(jcfg, opt, key=jax.random.PRNGKey(1))
    jtrain, ttrain = _sets(16, 4)
    kw = dict(batch_size=16, final_test=False, final_ood=False, seed=5)
    d = str(tmp_path / 'job')
    jtrainer.train_model(jjob, jtrain, epochs=1, save_dir=d,
                         outputs=JEpochOutput(stdout=False), **kw)
    tjob = tjobs.load_job(d, device='cpu')
    assert tjob.state.opt_state.count == tjob.state.opt_state.adam_count == 1
    assert tjob.state.step == 1 and tjob.trained == 1
    jres = jjobs.load_job(d)
    jtrainer.train_model(jres, jtrain, epochs=2,
                         outputs=JEpochOutput(stdout=False), **kw)
    ttrainer.train_model(tjob, ttrain, epochs=2,
                         outputs=EpochOutput(stdout=False), **kw)
    _close_tree(tjob.train_history[2], jres.train_history[2], TOL, 'history[2]')
    got = state_dict_to_jax(tjob.model)
    for k, v in jax_arrays(jres.state).items():
        close(got[k], v, TOL, k)


def test_port_job_loads_in_jax(tmp_path):
    opt = OptimizerConfig(lr=1e-3, grad_clipping=5.0, weight_decay=1e-4)
    tjob = tjobs.new_job(flagship_config(tiny=True), opt, seed=2, device='cpu')
    _, ttrain = _sets(32, 6)
    d = str(tmp_path / 'job')
    ttrainer.train_model(tjob, ttrain, epochs=1, batch_size=16, save_dir=d,
                         final_test=False, outputs=EpochOutput(stdout=False))
    jjob = jjobs.load_job(d)
    assert jjob.opt_cfg == jopt.OptimizerConfig(**opt.params)
    assert int(jjob.state.step) == 2 and int(jjob.state.epoch) == 0
    want = state_dict_to_jax(tjob.model)
    for k, v in jax_arrays(jjob.state).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    with np.load(os.path.join(d, 'optimizer.npz')) as z:
        saved = {k: z[k] for k in z.files}
    jopt_arrays = flatten_pytree(jjob.state.opt_state)
    assert set(jopt_arrays) == set(saved)
    for k, v in jopt_arrays.items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    assert int(jopt_arrays['1/inner_state/1/count']) == 2


def test_loader_batches_match_jax():
    x, y = _data(50, 7)
    aug = ['flip', 'crop']
    jl = jloaders.DataLoader(jloaders.ArrayDataset(x, y, 's'), 8, seed=4,
                             data_augmentation=aug, drop_last=True,
                             use_native=False)
    tl = tloaders.DataLoader(tloaders.ArrayDataset(x, y, 's'), 8, seed=4,
                             data_augmentation=aug, drop_last=True)
    assert len(tl) == len(jl) == 6
    for _ in range(2):                                  # two epochs
        for (jx, jy), (tx, ty) in zip(jl, tl):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    ev = tloaders.DataLoader(tloaders.ArrayDataset(x, y, 's'), 16,
                             shuffle=False)
    assert [len(b[1]) for b in ev] == [16, 16, 16, 2]


def test_nan_loss_marks_job_derailed(tmp_path):
    tjob = tjobs.new_job(flagship_config(tiny=True), seed=0, device='cpu')
    x, y = _data(32, 8)
    x[5] = np.nan
    d = str(tmp_path / 'job')
    ttrainer.train_model(tjob, tloaders.ArrayDataset(x, y, 's'), epochs=2,
                         batch_size=16, save_dir=d, final_test=False,
                         outputs=EpochOutput(stdout=False))
    assert tjobs.is_derailed(d)
    assert tjob.trained == 0


def test_unported_engines_raise():
    tjob = tjobs.new_job(flagship_config(tiny=True), seed=0, device='cpu')
    _, ttrain = _sets(16, 9)
    with pytest.raises(NotImplementedError, match='evaluation engines'):
        ttrainer.train_model(tjob, ttrain, ttrain, epochs=1, batch_size=16,
                             outputs=EpochOutput(stdout=False))
    with pytest.raises(NotImplementedError, match='dataset registry'):
        ttrainer.train_model(tjob, None)


@pytest.mark.parametrize('kw', [dict(), dict(lr=0.3, lr_decay=0.1),
                                dict(optim_type='sgd', momentum=0.9,
                                     nesterov=True, weight_decay=1e-4)])
def test_optimizer_config_and_format_match_jax(kw):
    tcfg, jcfg = OptimizerConfig(**kw), jopt.OptimizerConfig(**kw)
    assert tcfg.params == jcfg.params
    assert [tcfg.lr_at_epoch(e) for e in range(4)] == [jcfg.lr_at_epoch(e)
                                                       for e in range(4)]
    for level in (1, 2, 10):
        assert format_optimizer(tcfg, level) == jopt.format_optimizer(jcfg, level)


def test_learning_rate_injection_matches_jax():
    from joint_vae_tpu_torch.train.optimizers import (
        build_optimizer, get_learning_rate, set_learning_rate)
    jcfg = jopt.OptimizerConfig(lr=1e-3, grad_clipping=1.0)
    jst = jopt.build_optimizer(jcfg).init({'w': np.zeros(3, np.float32)})
    tst = build_optimizer(OptimizerConfig(lr=1e-3, grad_clipping=1.0)).init(
        {'w': torch.zeros(3)})
    assert get_learning_rate(tst) == jopt.get_learning_rate(jst)
    for lr in (3e-4, 0.1):
        jst = jopt.set_learning_rate(jst, lr)
        assert get_learning_rate(set_learning_rate(tst, lr)) == \
            jopt.get_learning_rate(jst)


def test_get_batch_and_split_match_jax():
    x, y = _data(40, 11)
    jds, tds = jloaders.ArrayDataset(x, y, 's'), tloaders.ArrayDataset(x, y, 's')
    for a, b in zip(tloaders.get_batch(tds, 16, seed=3),
                    jloaders.get_batch(jds, 16, seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ttrainer.split_validation(tds, 8, 2),
                    jtrainer.split_validation(jds, 8, 2)):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.targets, b.targets)
    assert tds.shape == jds.shape == (3, 8, 8)


def test_epoch_output_rows_match_jax():
    import io
    rows = []
    for cls in (EpochOutput, JEpochOutput):
        out = cls(stdout=False, ansi=False)
        buf = io.StringIO()
        out.streams.append(buf)
        for i in range(3):
            out.results(i, 3, 1, 2, preambule='train',
                        losses={'total': 12.5 - i, 'kl': float('nan')},
                        metrics={'dB': 7.25}, accuracy={'train': 0.5},
                        time_per_i=0.01, batch_size=64)
        rows.append(buf.getvalue())
    assert rows[0] == rows[1] and 'im/s' in rows[0]


def test_signal_levels():
    import signal
    from joint_vae_tpu_torch.utils.signaling import SIGHandler
    h = SIGHandler()
    h(signal.SIGUSR1, None)
    assert h.sig == 2
    h(signal.SIGTERM, None)
    assert h.sig == 3
    h(signal.SIGINT, None)
    assert h.sig == 5 and str(h) == 'SIGHandler(level=5)'
