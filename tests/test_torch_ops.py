"""The port's numeric ops against the JAX package on shared numpy inputs:
losses, the (L+1, eps0 = 0) sampling layout, the three prior families x
three variance forms x gather/all-classes paths (3e-4), the OOD scores
(including the torch-median and Bessel-std quirks) and label prediction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_vae_tpu.models.cvnet import CVNetConfig as JCVNetConfig
from joint_vae_tpu.ops import losses as jl
from joint_vae_tpu.ops import priors as jp
from joint_vae_tpu.ops import sampling as js
from joint_vae_tpu.ops import scores as jsc
from joint_vae_tpu.ops.sigma import SigmaConfig as JSigmaConfig

from joint_vae_tpu_torch.ops import losses as tl
from joint_vae_tpu_torch.ops import priors as tp
from joint_vae_tpu_torch.ops import sampling as ts
from joint_vae_tpu_torch.ops import scores as tsc

from torch_port_util import close, port_cfg

RNG = np.random.default_rng(0)
T = torch.from_numpy


def test_mse_loss_matches():
    out = RNG.uniform(0, 1, (3, 4, 5, 2, 6, 6)).astype(np.float32)
    tgt = RNG.uniform(0, 1, (5, 2, 6, 6)).astype(np.float32)
    for bm in (True, False):
        close(tl.mse_loss(T(out), T(tgt), ndim=3, batch_mean=bm),
              jl.mse_loss(jnp.asarray(out), jnp.asarray(tgt), ndim=3,
                          batch_mean=bm), 1e-6)


def test_categorical_loss_matches():
    out = RNG.normal(size=(3, 4, 256, 1, 4, 4)).astype(np.float32)
    tgt = RNG.uniform(0, 1, (4, 1, 4, 4)).astype(np.float32)
    for bm in (True, False):
        close(tl.categorical_loss(T(out), T(tgt), ndim=3, batch_mean=bm),
              jl.categorical_loss(jnp.asarray(out), jnp.asarray(tgt), ndim=3,
                                  batch_mean=bm), 1e-5)


@pytest.mark.parametrize('with_labels', [True, False])
def test_x_loss_matches(with_labels):
    logits = RNG.normal(size=(4, 3, 5, 7)).astype(np.float32)
    y = RNG.integers(0, 7, (3, 5)) if with_labels else None
    got = tl.x_loss(None if y is None else T(y), T(logits), batch_mean=False)
    want = jl.x_loss(None if y is None else jnp.asarray(y), jnp.asarray(logits),
                     batch_mean=False)
    assert tuple(got.shape) == want.shape
    close(got, want, 1e-5)


def test_sampling_layout():
    g = torch.Generator().manual_seed(0)
    for dist in ('gaussian', 'uniform'):
        eps = ts.draw_epsilon((6, 3), 4, dist, generator=g)
        assert eps.shape == (5, 6, 3)
        assert torch.all(eps[0] == 0) and torch.all(eps[1:] != 0)
        if dist == 'uniform':
            assert eps.abs().max() <= ts.SQRT12 / 2
    mu = RNG.normal(size=(6, 3)).astype(np.float32)
    lv = RNG.normal(size=(6, 3)).astype(np.float32)
    eps = RNG.normal(size=(5, 6, 3)).astype(np.float32)
    eps[0] = 0
    for sampled in (True, False):
        z, e1 = ts.reparameterize(T(mu), T(lv), 4, 'gaussian', sampled,
                                  eps=T(eps))
        want = mu[None] + np.exp(0.5 * lv)[None] * eps * float(sampled)
        close(z, want, 1e-6)
        close(e1, eps[1:], 0)
        close(z[0], mu, 0)       # sample 0 is the mean
    with pytest.raises(ValueError):
        ts.reparameterize(T(mu), T(lv), 3, eps=T(eps))
    # the JAX layout agrees: row 0 zero, L+1 rows
    je = js.draw_epsilon(jax.random.PRNGKey(0), (6, 3), 4)
    assert je.shape == (5, 6, 3) and float(jnp.abs(je[0]).max()) == 0.0


def _prior_params(cfg, rng):
    P, K = cfg.num_priors, cfg.dim
    mean = rng.normal(size=(P, K)).astype(np.float32) * 2
    if cfg.var_dim == 'scalar':
        v = rng.uniform(0.5, 2.0, ()).astype(np.float32)
    elif cfg.var_dim == 'diag':
        v = rng.uniform(0.5, 2.0, (K,)).astype(np.float32)
    else:
        v = np.tril(rng.normal(size=(K, K)) * 0.2).astype(np.float32)
        v[np.diag_indices(K)] = rng.uniform(0.5, 2.0, K)
    if cfg.conditional:
        v = np.stack([v * rng.uniform(0.7, 1.3) for _ in range(P)]).astype(np.float32)
    return {'mean': mean, 'var_param': v}


@pytest.mark.parametrize('var_dim', ['scalar', 'diag', 'full'])
@pytest.mark.parametrize('dist', ['gaussian', 'tilted', 'uniform'])
@pytest.mark.parametrize('mode', ['uncond', 'gather', 'all'])
def test_priors_match(dist, var_dim, mode):
    rng = np.random.default_rng(3)
    K, P, N, L = 6, 1 if mode == 'uncond' else 4, 5, 3
    kw = dict(dim=K, distribution=dist, num_priors=P, var_dim=var_dim,
              tau=3.0 if dist != 'gaussian' else 0.0)
    jcfg, tcfg = jp.PriorConfig(**kw), tp.PriorConfig(**kw)
    assert tcfg.params == jcfg.params
    params = _prior_params(jcfg, rng)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: T(v) for k, v in params.items()}
    mu = rng.normal(size=(N, K)).astype(np.float32) * 2
    lv = rng.normal(size=(N, K)).astype(np.float32) * 0.3
    z = rng.normal(size=(L, N, K)).astype(np.float32) * 2
    y = rng.integers(0, P, N) if mode == 'gather' else None
    yz = rng.integers(0, P, (L, N)) if mode == 'gather' else None
    all_classes = mode == 'all'

    jkl = jp.prior_kl(jcfg, jparams, jnp.asarray(mu), jnp.asarray(lv),
                      y=None if y is None else jnp.asarray(y),
                      var_weighting=0.7, all_classes=all_classes)
    tkl = tp.prior_kl(tcfg, tparams, T(mu), T(lv),
                      y=None if y is None else T(y),
                      var_weighting=0.7, all_classes=all_classes)
    assert set(jkl) == set(tkl)
    for k in jkl:
        assert tuple(tkl[k].shape) == jkl[k].shape, k
        close(tkl[k], jkl[k], 3e-4, k)
    jld = jp.prior_log_density(jcfg, jparams, jnp.asarray(z),
                               y=None if yz is None else jnp.asarray(yz),
                               all_classes=all_classes)
    tld = tp.prior_log_density(tcfg, tparams, T(z),
                               y=None if yz is None else T(yz),
                               all_classes=all_classes)
    assert tuple(tld.shape) == jld.shape
    close(tld, jld, 3e-4, 'log_density')


def test_prior_init_shapes():
    rng = np.random.default_rng(0)
    for var_dim, vshape in (('scalar', (4,)), ('diag', (4, 6)), ('full', (4, 6, 6))):
        cfg = tp.PriorConfig(dim=6, num_priors=4, var_dim=var_dim)
        a = tp.init_prior_arrays(cfg, rng)
        jparams = jp.init_prior_params(jp.PriorConfig(dim=6, num_priors=4,
                                                      var_dim=var_dim),
                                       jax.random.PRNGKey(0))
        assert a['mean'].shape == jparams['mean'].shape == (4, 6)
        assert a['var_param'].shape == jparams['var_param'].shape == vshape
        close(a['var_param'], jparams['var_param'], 0)
    onehot = tp.init_prior_arrays(tp.PriorConfig(dim=6, num_priors=4,
                                                 init_mean='onehot'), rng)
    close(onehot['mean'], np.eye(4, 6), 0)


SCORE_METHODS = ['iws', 'elbo', 'zdist', 'mse', 'soft', 'iws-2s', 'elbo-2s',
                 'mag', 'std', 'sum', 'max', 'mean', 'nstd', 'hyz', 'IYx',
                 'logits', 'baseline', 'baseline-10', 'softkl-10', 'softiws',
                 'softiws-10', 'softzdist-5', 'kl', 'wmse', 'iws-a-1-1',
                 'odin-2-0.0010']


def _losses(C, N, rng, per_class=True):
    shape = (C, N) if per_class else (N,)
    losses = {k: rng.normal(size=shape).astype(np.float32) * 5 + 30
              for k in ('total', 'iws', 'kl', 'zdist')}
    losses['iws'] = -losses['iws']
    for k in ('cross_x', 'wmse', 'odin-2-0.0010'):
        losses[k] = rng.normal(size=(N,)).astype(np.float32) * 3
    return losses


def _cfgs(type_, C):
    jcfg = JCVNetConfig(input_shape=(1, 4, 4), num_labels=C, type=type_,
                        encoder=(8,), decoder=(8,), classifier=(8,),
                        latent_dim=4, gamma=10.0, sigma=JSigmaConfig(value=0.5))
    return jcfg, port_cfg(jcfg)


@pytest.mark.parametrize('C', [6, 7])
def test_scores_match_cvae(C):
    rng = np.random.default_rng(C)
    N = 9
    jcfg, tcfg = _cfgs('cvae', C)
    losses = _losses(C, N, rng)
    logits = rng.normal(size=(N, C)).astype(np.float32)
    want = jsc.batch_dist_measures(jcfg, jnp.asarray(logits),
                                   {k: jnp.asarray(v) for k, v in losses.items()},
                                   SCORE_METHODS)
    got = tsc.batch_dist_measures(tcfg, T(logits),
                                  {k: T(v) for k, v in losses.items()},
                                  SCORE_METHODS)
    assert list(got) == SCORE_METHODS
    for m in SCORE_METHODS:
        close(got[m], want[m], 1e-4, m)


def test_scores_match_vae_and_errors():
    rng = np.random.default_rng(1)
    N = 9
    jcfg, tcfg = _cfgs('vae', 3)
    losses = _losses(3, N, rng, per_class=False)
    logits = rng.normal(size=(N, 3)).astype(np.float32)
    methods = ['iws', 'elbo', 'zdist', 'kl', 'elbo-2s']
    want = jsc.batch_dist_measures(jcfg, jnp.asarray(logits),
                                   {k: jnp.asarray(v) for k, v in losses.items()},
                                   methods)
    got = tsc.batch_dist_measures(tcfg, T(logits),
                                  {k: T(v) for k, v in losses.items()}, methods)
    for m in methods:
        close(got[m], want[m], 1e-5, m)
    with pytest.raises(ValueError):
        tsc.batch_dist_measures(tcfg, T(logits),
                                {k: T(v) for k, v in losses.items()}, ['bogus'])
    assert tsc.develop_starred_methods(['odin*', 'elbo']) == \
        jsc.develop_starred_methods(['odin*', 'elbo'])


@pytest.mark.parametrize('method', ['default', 'iws', 'closest', 'esty',
                                    'loss', 'mean', None])
def test_predict_after_evaluate_matches(method):
    rng = np.random.default_rng(5)
    C, N = 5, 8
    jcfg, tcfg = _cfgs('cvae', C)
    losses = _losses(C, N, rng)
    logits = rng.normal(size=(3, N, C) if method == 'mean' else (N, C)
                        ).astype(np.float32)
    want = jsc.predict_after_evaluate(jcfg, jnp.asarray(logits),
                                      {k: jnp.asarray(v) for k, v in losses.items()},
                                      method)
    got = tsc.predict_after_evaluate(tcfg, T(logits),
                                     {k: T(v) for k, v in losses.items()}, method)
    close(got, want, 1e-6)
