"""The port's evaluation engines (``evals/engines.py``, ``evals/odin.py``)
and the trainer's test and OOD passes against the JAX package's, on the
tiny flagship cvae and a tiny vib whose weights come from one JAX job
directory (``load_job`` converts them through ``from_jax``):

- replay tier: one recorder set, written by JAX's compute tier, feeds both
  packages' three engines; results agree within 1e-6, accuracies equal;
- compute tier: both packages draw the latent noise from one numpy array
  per shape (their ``reparameterize`` patched, nonzero noise); their
  record files agree within 5e-4 (PARITY.md's tolerance for evaluate) and
  so do the results;
- tier reuse: the json and recorder tiers run no forward;
- ODIN: the vib's scores (input gradient, temperatures, epsilons) against
  JAX within 5e-4;
- ``train_model`` with oodsets, the in-loop passes and the final ones:
  ``testing`` and ``ood_results`` match JAX's (z = mu in both).

The 'around-mean' ROC center (methods ending in ``-2s``) is a float32
mean whose last bit depends on the summation order: the port takes it in
float64 and rounds once, XLA sums in its own order (see
tests/test_torch_roc.py, which holds that geometry exactly on dyadic
scores).  So the ``-2s`` entries are held apart: their thresholds within
the tolerance plus 4 float32 ulps of the largest finite one, their rates and AUC within one sample
(1 / the smaller set's size), since a threshold ``center - |s - center|``
may land on the other side of ``s``.  Every other entry is held to the
stated tolerance, thresholds equal.
"""

import dataclasses
import os
import shutil
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import joint_vae_tpu.data.native as jnative
import joint_vae_tpu.models.evaluate as jev
import joint_vae_tpu.ops.sampling as jsampling
from joint_vae_tpu.data import loaders as jloaders
from joint_vae_tpu.evals import engines as jeng
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.save_load import recorders as jrec
from joint_vae_tpu.train import optimizers as jopt
from joint_vae_tpu.train import trainer as jtrainer
from joint_vae_tpu.utils.print_log import EpochOutput as JEpochOutput

import joint_vae_tpu_torch.data.native as tnative
import joint_vae_tpu_torch.evals.odin as todin
import joint_vae_tpu_torch.models.evaluate as tev
from joint_vae_tpu_torch.data import loaders as tloaders
from joint_vae_tpu_torch.evals import engines as teng
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load import recorders as trec
from joint_vae_tpu_torch.train import trainer as ttrainer
from joint_vae_tpu_torch.utils.print_log import EpochOutput

REPLAY_TOL = 1e-6
COMPUTE_TOL = 5e-4
TRAIN_TOL = 1e-4
BATCH = 16
VIB_METHODS = ['odin-1-0.0000', 'odin-1-0.0020', 'odin-10-0.0020',
               'baseline', 'logits']


@pytest.fixture(autouse=True)
def numpy_batches(monkeypatch):
    """Both packages batch with numpy (their native batchers agree with
    each other: ``tests/test_torch_native_batcher.py``)."""
    monkeypatch.setattr(jnative, 'available', lambda: False)
    monkeypatch.setattr(tnative, 'available', lambda: False)


def _noise(shape):
    """The (L+1, ...) noise of one shape, row 0 zero, from a seed that the
    shape fixes."""
    rng = np.random.default_rng(zlib.crc32(repr(tuple(shape)).encode()))
    eps = rng.standard_normal(shape).astype(np.float32)
    eps[0] = 0.0
    return eps


@pytest.fixture
def shared_noise(monkeypatch):
    def jax_fake(key, mu, log_var, L, dist='gaussian', sampled=True,
                 is_sampled=None):
        # evaluate passes ``sampled`` by position, CVNet.__call__ (ODIN's
        # forward) ``is_sampled`` by name
        sampled = sampled if is_sampled is None else is_sampled
        e = jnp.asarray(_noise((L + 1,) + tuple(mu.shape)))
        z = mu[None] + jnp.exp(0.5 * log_var)[None] * e * float(sampled)
        return z, e[1:]

    def port_fake(mu, log_var, L, dist='gaussian', sampled=True, *, eps=None,
                  generator=None):
        e = torch.from_numpy(_noise((L + 1,) + tuple(mu.shape))).to(mu.device)
        z = mu[None] + torch.exp(0.5 * log_var)[None] * e * float(sampled)
        return z, e[1:]
    monkeypatch.setattr(jev, 'reparameterize', jax_fake)
    monkeypatch.setattr(jsampling, 'reparameterize', jax_fake)
    monkeypatch.setattr(tev, 'reparameterize', port_fake)
    monkeypatch.setattr(todin, 'reparameterize', port_fake)


@pytest.fixture
def zero_noise(monkeypatch):
    def jax_fake(key, mu, log_var, L, dist, sampled):
        return (jnp.broadcast_to(mu[None], (L + 1,) + mu.shape),
                jnp.zeros((L,) + mu.shape, mu.dtype))

    def port_fake(mu, log_var, L, dist='gaussian', sampled=True, *, eps=None,
                  generator=None):
        return (mu[None].expand((L + 1,) + mu.shape),
                torch.zeros((L,) + mu.shape, dtype=mu.dtype, device=mu.device))
    monkeypatch.setattr(jev, 'reparameterize', jax_fake)
    monkeypatch.setattr(tev, 'reparameterize', port_fake)


def _jcfg(type_='cvae'):
    cfg = graft._flagship_cfg(tiny=True)
    if type_ == 'vib':
        cfg = dataclasses.replace(cfg, type='vib', test_latent_sampling=3)
    return cfg


def _sets(n, seed, name, labels=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, labels, n).astype(np.int32)
    return jloaders.ArrayDataset(x, y, name), tloaders.ArrayDataset(x, y, name)


def _jobs(tmp_path, type_='cvae', copies=1):
    """A fresh JAX job saved once; returns it and its directory, plus
    ``copies`` more directories holding the same files."""
    jjob = jjobs.new_job(_jcfg(type_), key=jax.random.PRNGKey(0))
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    dirs = [d]
    for i in range(copies):
        dirs.append(str(tmp_path / 'job{}'.format(i)))
        shutil.copytree(d, dirs[-1])
    return jjob, dirs


def _around_mean(got, want, tol, one_sample, what):
    """A ``-2s`` entry (module docstring): thresholds within ``tol`` and 4
    ulps of the largest finite one, rates and AUC within one sample, the
    rest within ``tol``."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        if k in ('thresholds', 'thresholds_up'):
            w = np.asarray(want[k], np.float32)
            big = np.max(np.abs(w[np.isfinite(w)]), initial=np.float32(1))
            np.testing.assert_allclose(got[k], w, rtol=tol,
                                       atol=4 * np.spacing(big),
                                       err_msg=what + '/' + k)
        elif k in ('auc', 'fpr', 'tpr', 'precision'):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=max(tol, one_sample),
                                       err_msg=what + '/' + k)
        else:
            _close_tree(got[k], want[k], tol, what + '/' + k)


def _close_tree(got, want, tol, what='', one_sample=None):
    """``got`` within ``tol`` of ``want``, key for key; the ``-2s``
    entries of result dicts by :func:`_around_mean` where ``one_sample``
    is given."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            sub = '{}/{}'.format(what, k)
            if (one_sample is not None and str(k).endswith('-2s')
                    and isinstance(want[k], dict) and 'thresholds' in want[k]):
                _around_mean(got[k], want[k], tol, one_sample, sub)
            else:
                _close_tree(got[k], want[k], tol, sub, one_sample)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, tol, '{}[{}]'.format(what, i), one_sample)
    elif isinstance(want, float) and not isinstance(got, bool):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)
    else:
        assert got == want, (what, got, want)


def _thresholds_equal(got, want):
    """Thresholds equal in every entry but the ``-2s`` ones."""
    for s, ms in want.items():
        for m, r in ms.items():
            if not m.endswith('-2s'):
                for k in ('thresholds', 'thresholds_up'):
                    assert got[s][m][k] == r[k], (s, m, k)


def test_replay_tier_matches_jax(tmp_path):
    jjob, (d,) = _jobs(tmp_path, copies=0)
    (jts, tts), (jo1, to1), (jo2, to2) = (_sets(40, 1, 'test'),
                                          _sets(24, 2, 'ooda'),
                                          _sets(24, 3, 'oodb'))
    # one recorder set, from JAX's compute tier
    jeng.ood_detection_rates(jjob, jts, [jo1, jo2], batch_size=BATCH,
                             from_where=('compute',), update_self_ood=False)
    tjob = tjobs.load_job(d, device='cpu')
    jres = jjobs.load_job(d)
    kw = dict(batch_size=BATCH, from_where=('recorders',))
    want = jeng.ood_detection_rates(jres, jts, [jo1, jo2], **kw)
    got = teng.ood_detection_rates(tjob, tts, [to1, to2], **kw)
    _close_tree(got, want, REPLAY_TOL, 'ood', one_sample=1 / 24)
    _thresholds_equal(got, want)
    assert jres.ood_results
    _close_tree(tjob.ood_results, jres.ood_results, REPLAY_TOL, 'ood.json',
                one_sample=1 / 24)
    kw['from_where'] = ('json', 'recorders')
    want = jeng.accuracy(jres, jts, **kw)
    got = teng.accuracy(tjob, tts, **kw)
    assert got == want and set(got) == set(jres.model_cfg.predict_methods)
    want = jeng.misclassification_detection_rates(jres, jts, **kw)
    got = teng.misclassification_detection_rates(tjob, tts, **kw)
    assert len(got) == len(want) > 0
    _close_tree(got, want, REPLAY_TOL, 'misclass')
    _close_tree(tjob.testing, jres.testing, REPLAY_TOL, 'testing')


def test_compute_tier_and_reuse_match_jax(tmp_path, shared_noise,
                                          monkeypatch):
    jjob, (dj, dt) = _jobs(tmp_path)
    tjob = tjobs.load_job(dt, device='cpu')
    jjob.saved_dir = dj
    # 40 = 2 full batches + a ragged 8: JAX scans the full ones
    (jts, tts), (jo1, to1) = _sets(40, 1, 'test'), _sets(24, 2, 'ooda')
    want = jeng.ood_detection_rates(jjob, jts, [jo1], batch_size=BATCH)
    got = teng.ood_detection_rates(tjob, tts, [to1], batch_size=BATCH)
    _close_tree(got, want, COMPUTE_TOL, 'ood', one_sample=1 / 24)
    want_acc = jeng.accuracy(jjob, jts, batch_size=BATCH,
                             from_where=('compute',))
    got_acc = teng.accuracy(tjob, tts, batch_size=BATCH,
                            from_where=('compute',))
    assert got_acc == want_acc
    for name in ('test', 'ooda'):
        a = trec.LossRecorder.load(trec.find_record(
            os.path.join(dt, 'samples', '0000'), name))
        b = jrec.LossRecorder.load(jrec.find_record(
            os.path.join(dj, 'samples', '0000'), name))
        assert a.recorded_samples == b.recorded_samples == (40 if name ==
                                                             'test' else 24)
        assert set(a.keys()) == set(b.keys())
        for k in b.keys():
            np.testing.assert_allclose(a.get(k), b.get(k), rtol=COMPUTE_TOL,
                                       atol=COMPUTE_TOL, err_msg=k)

    # tier reuse: the json tier, then the recorders alone, run no forward
    forwards = []
    real = teng.evaluate
    monkeypatch.setattr(teng, 'evaluate',
                        lambda *a, **k: forwards.append(1) or real(*a, **k))
    again = teng.ood_detection_rates(tjob, tts, [to1], batch_size=BATCH)
    assert again == got
    tjob.ood_results.clear()
    tjob.testing.clear()
    rec = teng.ood_detection_rates(tjob, tts, [to1], batch_size=BATCH,
                                   from_where=('json', 'recorders'))
    _close_tree(rec, got, REPLAY_TOL, 'recorder tier')
    assert teng.accuracy(tjob, tts, batch_size=BATCH) == got_acc
    assert teng.misclassification_detection_rates(tjob, tts,
                                                  batch_size=BATCH)
    assert forwards == []


def test_odin_scores_match_jax(tmp_path, shared_noise):
    jjob, (d,) = _jobs(tmp_path, 'vib', copies=0)
    tjob = tjobs.load_job(d, device='cpu')
    jres = jjobs.load_job(d)
    (jts, tts), (jo1, to1) = _sets(20, 4, 'test'), _sets(20, 5, 'ooda')
    kw = dict(batch_size=BATCH, method=VIB_METHODS, from_where=('compute',))
    want = jeng.ood_detection_rates(jres, jts, [jo1], **kw)
    got = teng.ood_detection_rates(tjob, tts, [to1], **kw)
    _close_tree(got, want, COMPUTE_TOL, 'ood')
    for name in ('test', 'ooda'):
        a = trec.LossRecorder.load(trec.find_record(
            os.path.join(d, 'samples', '0000'), name))
        for m in VIB_METHODS[:3]:
            assert a.get(m).shape == (20,)
    # the port's scores against the JAX grid directly, at one batch
    x = jts.data[:BATCH]
    jodin = jeng.make_odin_scores(jres.model, temps=[1, 10],
                                  eps_grid=[0.0, 0.002])
    want = jodin(jres.state.variables, jnp.asarray(x), jax.random.PRNGKey(0))
    got = todin.make_odin_scores(tjob.model, temps=[1, 10],
                                 eps_grid=[0.0, 0.002])(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=COMPUTE_TOL, atol=COMPUTE_TOL,
                                   err_msg=k)
    assert all(p.requires_grad for p in tjob.model.parameters())


def test_train_model_test_and_ood_passes_match_jax(tmp_path, zero_noise):
    jcfg = dataclasses.replace(_jcfg(), beta=0.0)
    jjob = jjobs.new_job(jcfg, jopt.OptimizerConfig(lr=2e-3),
                         key=jax.random.PRNGKey(0))
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    tjob = tjobs.load_job(d, device='cpu')
    (jtrain, ttrain), (jts, tts) = _sets(32, 6, 'train'), _sets(24, 7, 'test')
    (jo1, to1), = (_sets(24, 8, 'ooda'),)
    kw = dict(epochs=2, batch_size=16, test_batch_size=BATCH,
              full_test_every=1, ood_detection_every=1, test_sample_size=16,
              seed=2)
    jtrainer.train_model(jjob, jtrain, jts, [jo1],
                         outputs=JEpochOutput(stdout=False),
                         save_dir=str(tmp_path / 'j'), **kw)
    ttrainer.train_model(tjob, ttrain, tts, [to1],
                         outputs=EpochOutput(stdout=False),
                         save_dir=str(tmp_path / 't'), **kw)
    assert set(tjob.ood_results) == set(jjob.ood_results) == {1, 2}
    assert set(tjob.testing) == set(jjob.testing) == {0, 1, 2}
    # the in-loop passes score 16 test images (test_sample_size)
    _close_tree(tjob.ood_results, jjob.ood_results, TRAIN_TOL, 'ood_results',
                one_sample=1 / 16)
    _close_tree(tjob.testing, jjob.testing, TRAIN_TOL, 'testing')
    assert tjob.testing[1]['iws']['n'] == 16           # capped in the loop
    assert tjob.ood_results[2]['ooda']['iws']['n'] == 24
