"""The port's analysis modules against the JAX package's, on tiny
flagship jobs that the JAX package wrote (``load_job`` reads them):

- ``evals/sample.py``: the reconstruction grid, the latent samples and
  the cross-model comparison with injected noise (5e-4, PARITY.md's
  evaluate tolerance), the correct/incorrect pools (equal), and the
  generation grid with injected prior noise for every prior ``var_dim``
  (scalar, diag, full; per-class and shared means);
- ``evals/aggregation.py``: every ensemble posterior and the latent
  mutual information (numpy: 1e-12), and ``latent_mutual_info_tensors``
  (5e-4; the predictions equal);
- ``evals/cascad.py``: ``CascadModels.evaluate`` over two jobs (5e-4)
  and ``iterate_with_prior`` (1e-12);
- ``utils/mutual_information.py`` (1e-12) and ``tile_images`` /
  ``save_grid_image`` (bytes and arrays equal).

The noise of ``evaluate`` is the shape-seeded array of
``tests/test_torch_engines.py`` (``shared_noise``) or an injected one;
the prior draw of ``generation_grid`` is injected on both sides (JAX
draws it with ``jax.random.normal``, which torch cannot reproduce).
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from joint_vae_tpu.data import loaders as jloaders
from joint_vae_tpu.evals import aggregation as jagg
from joint_vae_tpu.evals import cascad as jcascad
from joint_vae_tpu.evals import sample as jsample
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.utils import mutual_information as jmi

from joint_vae_tpu_torch.data import loaders as tloaders
from joint_vae_tpu_torch.evals import aggregation as tagg
from joint_vae_tpu_torch.evals import cascad as tcascad
from joint_vae_tpu_torch.evals import sample as tsample
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.utils import mutual_information as tmi

from test_torch_engines import numpy_batches, shared_noise  # noqa: F401
from torch_port_util import close, inject_jax_eps, make_eps

TOL = 5e-4
NUMPY_TOL = 1e-12
N = 6


def _jax_job(tmp_path, name, seed=0, **prior_kw):
    """A tiny flagship JAX job (prior variance perturbed so that its
    inverse matters), saved and loaded by both packages."""
    cfg = graft._flagship_cfg(tiny=True)
    if prior_kw:
        cfg = dataclasses.replace(
            cfg, prior=dataclasses.replace(cfg.prior, **prior_kw))
    job = jjobs.new_job(cfg, key=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
    vp = np.asarray(job.state.params['prior']['var_param'])
    noise = rng.uniform(-0.3, 0.3, vp.shape).astype(np.float32)
    if cfg.prior.var_dim == 'full':
        noise = np.tril(noise)
    params = dict(job.state.params)
    params['prior'] = dict(params['prior'], var_param=jnp.asarray(vp + noise))
    job.state = job.state.replace(params=params)
    d = str(tmp_path / name)
    jjobs.save_job(job, d)
    return jjobs.load_job(d), tjobs.load_job(d, device='cpu')


@pytest.fixture(scope='module')
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp('driver_jobs')
    return {v: _jax_job(root, v, seed=i, var_dim=v)
            for i, v in enumerate(('scalar', 'diag', 'full'))}


def _x(n=N, seed=3):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 3, 8, 8)).astype(np.float32)


def _prior_noise(shape):
    return np.random.default_rng(sum(shape)).standard_normal(
        shape).astype(np.float32)


def test_reconstruction_grid_matches_jax(jobs, monkeypatch):
    jj, tj = jobs['scalar']
    L = 3
    x, y = _x(), np.arange(N, dtype=np.int32) % 4
    eps = make_eps((L + 1, N, 16))
    inject_jax_eps(monkeypatch, eps)
    want = jsample.reconstruction_grid(jj, x, y, L=L)
    got = tsample.reconstruction_grid(tj, x, y, L=L,
                                      eps=torch.from_numpy(eps))
    assert set(got) == set(want) == {'input', 'mean', 'average', 'samples',
                                     'correct'}
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if v.dtype == bool or k == 'input':
            assert np.array_equal(got[k], v), k
        else:
            close(got[k], v, TOL, k)


@pytest.mark.parametrize('var_dim', ['scalar', 'diag', 'full'])
@pytest.mark.parametrize('class_means', [True, False],
                         ids=['class_means', 'one_mean'])
def test_generation_grid_matches_jax(jobs, var_dim, class_means,
                                     monkeypatch):
    """Every var_dim inverts the prior's inverse scale the same way."""
    jj, tj = jobs[var_dim]
    P = 4 if class_means else 1
    eps = _prior_noise((P, 3, 16))
    fake = types.SimpleNamespace(
        random=types.SimpleNamespace(
            PRNGKey=jax.random.PRNGKey,
            normal=lambda key, shape: jnp.asarray(_prior_noise(shape))),
        jit=jax.jit)
    monkeypatch.setattr(jsample, 'jax', fake)
    want = jsample.generation_grid(jj, n_per_class=3,
                                   use_class_means=class_means)
    got = tsample.generation_grid(tj, n_per_class=3,
                                  use_class_means=class_means, eps=eps)
    assert got.shape == want.shape == (P, 3, 3, 8, 8)
    close(got, want, TOL, var_dim)


def test_latent_samples_matches_jax(jobs, monkeypatch):
    jj, tj = jobs['diag']
    x = _x()
    eps = make_eps((2, N, 16), seed=5)
    inject_jax_eps(monkeypatch, eps)
    want = jsample.latent_samples(jj, x)
    got = tsample.latent_samples(tj, x, eps=torch.from_numpy(eps))
    for g, w, what in zip(got, want, ('mu', 'log_var', 'z')):
        close(g, w, TOL, what)


def test_compare_reconstructions_matches_jax(jobs, shared_noise):
    x = _x()
    pairs = [jobs['scalar'], jobs['full']]
    want_d, want_r = jsample.compare_reconstructions([p[0] for p in pairs], x)
    got_d, got_r = tsample.compare_reconstructions([p[1] for p in pairs], x)
    close(got_r, want_r, TOL, 'recos')
    close(got_d, want_d, TOL, 'mse')


def test_select_correct_incorrect_matches_jax(jobs, shared_noise):
    jj, tj = jobs['scalar']
    data = (np.random.default_rng(8).uniform(0, 1, (40, 3, 8, 8)) * 255
            ).astype(np.uint8)
    targets = np.arange(40, dtype=np.int64) % 4
    want = jsample.select_correct_incorrect(
        jj, jloaders.ArrayDataset(data, targets, 'tiny'), 5, batch_size=16)
    got = tsample.select_correct_incorrect(
        tj, tloaders.ArrayDataset(data, targets, 'tiny'), 5, batch_size=16)
    assert set(got) == set(want) == {'correct', 'incorrect'}
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert np.array_equal(g, w), k


METHODS = ['dist', 'joint', 'elbo', 'lme', 'iws', 'mean', 'mean~', 'vote']


@pytest.mark.parametrize('method', METHODS)
def test_ensemble_posterior_matches_jax(method):
    rng = np.random.default_rng(2)
    scores = [rng.normal(0, 5, (7, 50)).astype(np.float32) for _ in range(3)]
    want = jagg.ensemble_posterior(scores, method)
    got = tagg.ensemble_posterior(scores, method)
    np.testing.assert_allclose(got, want, rtol=NUMPY_TOL, atol=NUMPY_TOL)
    assert np.array_equal(tagg.ensemble_predict(scores, method),
                          jagg.ensemble_predict(scores, method))


def test_ensemble_posterior_unknown_method():
    with pytest.raises(ValueError):
        tagg.ensemble_posterior([np.zeros((2, 3))], 'median')


def test_mutual_information_matches_jax():
    rng = np.random.default_rng(4)
    p1, p2 = rng.dirichlet(np.ones(5), 30).T, rng.dirichlet(np.ones(5), 30).T
    assert tagg.compute_latent_mutual_info(p1, p2) == pytest.approx(
        jagg.compute_latent_mutual_info(p1, p2), rel=NUMPY_TOL, abs=NUMPY_TOL)
    joint = rng.uniform(0, 1, (4, 6))
    p, q = rng.dirichlet(np.ones(6), 3), rng.dirichlet(np.ones(6), 3)
    for name, args in (('mutual_information', (joint,)),
                       ('entropy', (p,)), ('kl_divergence', (p, q)),
                       ('js_divergence', (p, q))):
        np.testing.assert_allclose(getattr(tmi, name)(*args),
                                   getattr(jmi, name)(*args),
                                   rtol=NUMPY_TOL, atol=NUMPY_TOL,
                                   err_msg=name)


def test_latent_mutual_info_tensors_matches_jax(jobs, shared_noise):
    x = _x(8, seed=6)
    (j1, t1), (j2, t2) = jobs['scalar'], jobs['diag']
    want, wy = jagg.latent_mutual_info_tensors(j1, j2, x)
    got, gy = tagg.latent_mutual_info_tensors(t1, t2, x)
    assert set(got) == set(want)
    for T, v in want.items():
        assert got[T].dtype == np.float32
        close(got[T], v, TOL, 'Im-{}'.format(T))
    assert np.array_equal(gy, wy)


def test_cascade_evaluate_matches_jax(jobs, shared_noise):
    x = _x(8, seed=7)
    pairs = [jobs['scalar'], jobs['full']]
    want = jcascad.CascadModels(*[p[0] for p in pairs]).evaluate(x)
    got = tcascad.CascadModels(*[p[1] for p in pairs]).evaluate(x)
    for g, w in zip(got[0], want[0]):
        assert set(g) == set(w)
        for k, v in w.items():
            close(g[k], v, TOL, k)
    close(got[1], want[1], TOL, 'recos')
    close(got[2], want[2], TOL, 'mse')
    for g, w in zip(got[3], want[3]):
        close(g, w, TOL, 'posterior')


def test_cascade_needs_one_input_shape(jobs):
    tj = jobs['scalar'][1]
    other = tjobs.new_job(dataclasses.replace(
        tj.model_cfg, input_shape=(1, 4, 4), features=None, upsampler=None),
        device='cpu')
    with pytest.raises(ValueError, match='one input shape'):
        tcascad.CascadModels(tj, other)


@pytest.mark.parametrize('prior', [None, 'skewed'])
def test_iterate_with_prior_matches_jax(prior):
    rng = np.random.default_rng(9)
    posts = [rng.dirichlet(np.ones(5), 20).T for _ in range(3)] + [None]
    pr = None if prior is None else np.array([0.4, 0.3, 0.1, 0.1, 0.1])
    np.testing.assert_allclose(tcascad.iterate_with_prior(posts, pr),
                               jcascad.iterate_with_prior(posts, pr),
                               rtol=NUMPY_TOL, atol=NUMPY_TOL)


@pytest.mark.parametrize('channels', [1, 3])
def test_tile_images_and_grid_files_match_jax(tmp_path, channels):
    rng = np.random.default_rng(channels)
    rows = [rng.uniform(-0.2, 1.2, (n, channels, 5, 4)) for n in (3, 2, 4)]
    want = jsample.tile_images(rows)
    got = tsample.tile_images(rows)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes() and got.shape == want.shape
    grid = {'input': rows[0], 'mean': rows[0] * 0.5, 'average': rows[0],
            'samples': np.stack([rows[0]] * 4)}
    jsample.save_grid_image(grid, str(tmp_path / 'jax' / 'g'))
    tsample.save_grid_image(grid, str(tmp_path / 'torch' / 'g'))
    with np.load(str(tmp_path / 'jax' / 'g.npz')) as a, \
            np.load(str(tmp_path / 'torch' / 'g.npz')) as b:
        assert a.files == b.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    assert (os.path.exists(str(tmp_path / 'jax' / 'g.png'))
            == os.path.exists(str(tmp_path / 'torch' / 'g.png')))
