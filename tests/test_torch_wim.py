"""The port's WIM pieces (``ft/wim.py``, ``models/evaluate.py``'s
``prior_override``, ``ops/scores.py``'s WIM branch) against the JAX
package, on the CPU and the tiny flagship, with the latent noise injected
(the L+1 layout, eps_0 = 0) and the alternate prior's arrays handed
across (the packages draw them from different generators):

- ``evaluate(prior_override=...)`` for a mean-shifted gaussian, a tilted,
  a uniform and a one-mean class-conditional alternate prior, per class
  at test time and with labels in training (the mix half of a step):
  every loss and measure within 5e-4;
- ``evaluate_on_both_priors``: losses and '@' twins within 5e-4, both
  evaluations on the same noise when it comes from a generator;
- the WIM scores of every method of ``WIM_OOD_METHODS_PER_TYPE`` and
  ``WIM_MISCLASS_METHODS_PER_TYPE`` on shared losses within 1e-6, through
  ``wim_scores_for_set`` and through ``batch_dist_measures`` (the engines'
  recorder tier);
- ``finetune_batch`` over 12 steps from one init, with the same batches
  and noise, weight decay on: every step's metrics, then the parameters,
  the optimizer state (``save_load/from_jax.opt_state_to_jax``) and the
  sigma state within 1e-4; the prior and the BatchNorm statistics
  exactly unchanged.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from joint_vae_tpu.ft import job as jftjob
from joint_vae_tpu.ft import wim as jwim
from joint_vae_tpu.models import evaluate as jev
from joint_vae_tpu.models.cvnet import CVNetConfig as JCVNetConfig
from joint_vae_tpu.ops import priors as jpriors
from joint_vae_tpu.ops import scores as jscores
from joint_vae_tpu.ops import sigma as jsigma
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.save_load.checkpoint import flatten_pytree
from joint_vae_tpu.train import optimizers as jopt

from joint_vae_tpu_torch.ft import job as tftjob
from joint_vae_tpu_torch.ft import wim as twim
from joint_vae_tpu_torch.models import evaluate as tev
from joint_vae_tpu_torch.ops import priors as tpriors
from joint_vae_tpu_torch.ops import scores as tscores
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.from_jax import (opt_state_to_jax,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  build_optimizer)
from joint_vae_tpu_torch.train.state import make_generator, named_params

from torch_port_util import (close, inject_jax_eps, jax_arrays, make_eps,
                             port_cfg, port_sigma_state)

EVAL_TOL = 5e-4
SCORE_TOL = 1e-6
STEP_TOL = 1e-4
N = 6

ALTERNATES = {
    'gaussian': dict(distribution='gaussian', init_mean=8.0, num_priors=1),
    'tilted': dict(distribution='tilted', tau=25.0, num_priors=1),
    'uniform': dict(distribution='uniform', tau=5.0, num_priors=1),
    'conditional_one_mean': dict(distribution='gaussian', init_mean=8.0,
                                 num_priors=1, force_conditional=True),
}


def _tiny(**kw):
    return dataclasses.replace(graft._flagship_cfg(tiny=True), **kw)


def _jjob(jcfg, opt=None, seed=0):
    return jjobs.new_job(jcfg, jopt.OptimizerConfig(**(opt or {})),
                         key=jax.random.PRNGKey(seed))


def _port_job(jjob, tmp_path):
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    return tjobs.load_job(d, device='cpu')


def _alternate(K, kw, seed=3):
    """The alternate prior in both packages: its arrays drawn by the port
    and handed to JAX."""
    kw = dict(kw)
    dist = kw.pop('distribution')
    tcfg = tpriors.build_prior_config(K, dist, **kw)
    arrays = tpriors.init_prior_arrays(tcfg, np.random.default_rng(seed))
    jcfg = jpriors.build_prior_config(K, dist, **kw)
    return ((jcfg, {k: jnp.asarray(v) for k, v in arrays.items()}),
            (tcfg, {k: torch.from_numpy(v) for k, v in arrays.items()}))


def _x(jcfg, n=N, seed=5):
    return np.random.default_rng(seed).uniform(
        0, 1, (n,) + jcfg.input_shape).astype(np.float32)


def _close_dict(got, want, tol, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, v in want.items():
        close(got[k], v, tol, '{} {}'.format(what, k))


@pytest.mark.parametrize('mode', ['per_class', 'train_labels'])
@pytest.mark.parametrize('alt', sorted(ALTERNATES))
def test_evaluate_prior_override_matches_jax(alt, mode, tmp_path,
                                             monkeypatch):
    jcfg = _tiny()
    jjob = _jjob(jcfg)
    tjob = _port_job(jjob, tmp_path)
    jalt, talt = _alternate(jcfg.latent_dim, ALTERNATES[alt])
    train = mode == 'train_labels'
    L = jcfg.latent_sampling if train else jcfg.test_latent_sampling
    eps = make_eps((L + 1, N, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    x = _x(jcfg)
    y = np.zeros(N, np.int32) if train else None
    kw = dict(train=train, with_beta=train, bn_eval=train)
    want = jev.evaluate(jjob.model, jjob.state.variables, jnp.asarray(x),
                        None if y is None else jnp.asarray(y),
                        rng=jax.random.PRNGKey(1),
                        sigma_state=jjob.state.sigma_state,
                        prior_override=jalt, **kw)
    got = tev.evaluate(tjob.model, torch.from_numpy(x),
                       None if y is None else torch.from_numpy(y),
                       sigma_state=tjob.sigma_state, prior_override=talt,
                       eps=torch.from_numpy(eps), **kw)
    _close_dict(got.losses, want.losses, EVAL_TOL, 'losses')
    _close_dict(got.measures, want.measures, EVAL_TOL, 'measures')
    # the override really took: the KL is not the model prior's
    own = tev.evaluate(tjob.model, torch.from_numpy(x),
                       None if y is None else torch.from_numpy(y),
                       sigma_state=tjob.sigma_state,
                       eps=torch.from_numpy(eps), **kw)
    assert not torch.allclose(own.losses['kl'], got.losses['kl'])


def _wims(jjob, tjob, seed=3):
    jw = jwim.WIMJob(job=jjob)
    jw.set_alternate_prior(key=jax.random.PRNGKey(seed), init_mean=8.0,
                           num_priors=1, seed=seed)
    tw = twim.WIMJob(job=tjob)
    tw.set_alternate_prior(init_mean=8.0, num_priors=1, seed=seed)
    assert tw.ft_params == jw.ft_params
    assert tw.alternate_prior_cfg.params == jw.alternate_prior_cfg.params
    tw.set_alternate_prior_arrays({k: np.asarray(v) for k, v in
                                   jw.alternate_prior_params.items()})
    return jw, tw


def test_evaluate_on_both_priors_matches_jax(tmp_path, monkeypatch):
    jcfg = _tiny()
    jjob = _jjob(jcfg)
    tjob = _port_job(jjob, tmp_path)
    jw, tw = _wims(jjob, tjob)
    L = jcfg.test_latent_sampling
    eps = make_eps((L + 1, N, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    x = _x(jcfg)
    _, jlogits, jlosses, _ = jw.evaluate_on_both_priors(
        jjob.state.variables, jnp.asarray(x), rng=jax.random.PRNGKey(1),
        sigma_state=jjob.state.sigma_state)
    _, tlogits, tlosses, _ = tw.evaluate_on_both_priors(
        torch.from_numpy(x), sigma_state=tjob.sigma_state,
        eps=torch.from_numpy(eps))
    assert any(k.endswith('@') for k in jlosses)
    _close_dict(tlosses, jlosses, EVAL_TOL, 'losses')
    close(tlogits, jlogits, EVAL_TOL, 'logits')


def test_both_priors_share_the_generators_noise(tmp_path):
    """Without injected noise both evaluations draw the same noise (the
    JAX package gives both one key): the reconstruction terms are equal,
    and the generator moves on as after one evaluation."""
    jjob = _jjob(_tiny())
    tjob = _port_job(jjob, tmp_path)
    _, tw = _wims(jjob, tjob)
    x = torch.from_numpy(_x(jjob.model_cfg))
    g = make_generator('cpu', 11)
    _, _, losses, _ = tw.evaluate_on_both_priors(
        x, sigma_state=tjob.sigma_state, generator=g)
    assert torch.equal(losses['cross_x'], losses['cross_x@'])
    assert torch.equal(losses['iws'], tev.evaluate(
        tjob.model, x, sigma_state=tjob.sigma_state,
        generator=make_generator('cpu', 11)).losses['iws'])
    h = make_generator('cpu', 11)
    tev.evaluate(tjob.model, x, sigma_state=tjob.sigma_state, generator=h)
    assert torch.equal(g.get_state(), h.get_state())


def _vae_cfg():
    return JCVNetConfig(input_shape=(1, 6, 6), num_labels=3, type='vae',
                        encoder=(12,), decoder=(12,), latent_dim=4,
                        latent_sampling=1, test_latent_sampling=2,
                        sigma=jsigma.SigmaConfig(value=0.3),
                        prior=jpriors.PriorConfig(dim=4))


def _shared_losses(jcfg, n=40, seed=0):
    """Losses as a WIM job records them: per-class (C, N) for a cvae with
    (N,) '@' twins, per-input for a vae; logits and kl-argmin labels."""
    rng = np.random.default_rng(seed)
    C = jcfg.num_labels
    shape = (C, n) if jcfg.losses_per_class else (n,)
    losses = {}
    for k in ('total', 'kl', 'zdist', 'iws', 'cross_x'):
        losses[k] = rng.normal(50, 20, shape).astype(np.float32)
        losses[k + '@'] = rng.normal(80, 20, (n,)).astype(np.float32)
    losses['logits'] = rng.normal(0, 2, (n, C)).astype(np.float32)
    losses['y_true'] = rng.integers(0, C, n).astype(np.int32)
    return losses


def _score_cases():
    out = []
    for type_, ms in sorted(jwim.WIM_OOD_METHODS_PER_TYPE.items()):
        out += [(type_, m) for m in ms]
    for type_, ms in sorted(jwim.WIM_MISCLASS_METHODS_PER_TYPE.items()):
        out += [(type_, m) for m in ms if (type_, m) not in out]
    return out


@pytest.mark.parametrize('type_,method', _score_cases(),
                         ids=['{}-{}'.format(*c) for c in _score_cases()])
def test_wim_scores_match_jax(type_, method):
    jcfg = _tiny() if type_ == 'cvae' else _vae_cfg()
    losses = _shared_losses(jcfg)
    want = jftjob.wim_scores_for_set(types.SimpleNamespace(cfg=jcfg),
                                     losses, [method])
    got = tftjob.wim_scores_for_set(
        types.SimpleNamespace(cfg=port_cfg(jcfg)), losses, [method])
    assert set(got) == set(want) == {method}
    close(got[method], want[method], SCORE_TOL, method)
    assert got[method].dtype == np.float32


def test_wim_scores_through_the_engines_scoring_match_jax():
    """batch_dist_measures scores the WIM methods of a recorded set from
    its twins and ``y_est_already``, as JAX's does (the recorder tier)."""
    jcfg = _tiny()
    losses = _shared_losses(jcfg)
    losses['y_est_already'] = np.argmin(losses['kl'], axis=0).astype(np.int32)
    methods = (jwim.WIM_OOD_METHODS_PER_TYPE['cvae']
               + jwim.WIM_MISCLASS_METHODS_PER_TYPE['cvae'] + ['zdist~-2s'])
    keys = [k for k in losses if k not in ('logits', 'y_true')]
    want = jscores.batch_dist_measures(
        jcfg, jnp.asarray(losses['logits']),
        {k: jnp.asarray(losses[k]) for k in keys}, methods)
    got = tscores.batch_dist_measures(
        port_cfg(jcfg), torch.from_numpy(losses['logits']),
        {k: torch.from_numpy(losses[k]) for k in keys}, methods)
    _close_dict(got, want, SCORE_TOL, 'scores')


STEP_CASES = {
    'flagship_tiny': dict(cfg={}),
    'batch_norm_sigma_decay': dict(cfg=dict(
        batch_norm='both',
        sigma=jsigma.SigmaConfig(value=0.3, decay=0.1, reach=1.5,
                                 max_step=0.02))),
}


@pytest.mark.parametrize('name', sorted(STEP_CASES))
def test_finetune_batch_matches_jax_over_12_steps(name, tmp_path,
                                                  monkeypatch):
    jcfg = _tiny(**STEP_CASES[name]['cfg'])
    opt = dict(optim_type='adam', lr=1e-3, weight_decay=1e-3)
    jjob = _jjob(jcfg, opt, seed=2)
    tjob = _port_job(jjob, tmp_path)
    jw, tw = _wims(jjob, tjob)
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
    before = jax_arrays(jjob.state)

    rng = np.random.default_rng(4)
    for t in range(12):
        xi = rng.uniform(0, 1, (N,) + jcfg.input_shape).astype(np.float32)
        yi = rng.integers(0, jcfg.num_labels, N).astype(np.int32)
        xm = rng.uniform(0, 1, (N,) + jcfg.input_shape).astype(np.float32)
        jst, jm = jstep(jst, jnp.asarray(xi), jnp.asarray(yi),
                        jnp.asarray(xm), jax.random.PRNGKey(t))
        tst, tm = tw.finetune_batch(
            tst, torch.from_numpy(xi), torch.from_numpy(yi),
            torch.from_numpy(xm), alpha, tx=ttx,
            train_L=jcfg.latent_sampling, eps=torch.from_numpy(eps))
        _close_dict(tm, jm, STEP_TOL, 'step {}'.format(t))
    assert tst.step == int(jst.step) == 12
    got = state_dict_to_jax(tst.model)
    want = jax_arrays(jst)
    for k, v in want.items():
        close(got[k], v, STEP_TOL, k)
        if k.startswith(('params/prior/', 'batch_stats/')):
            assert np.array_equal(got[k], before[k]), k
            assert np.array_equal(v, before[k]), k
        elif k.startswith('params/'):
            assert not np.array_equal(got[k], before[k]), k
    assert any(k.startswith('batch_stats/') for k in want) == (
        name == 'batch_norm_sigma_decay')
    want_opt = flatten_pytree(jst.opt_state)
    got_opt = opt_state_to_jax(tst.model, OptimizerConfig(**opt),
                               tst.opt_state)
    assert set(got_opt) == set(want_opt)
    for k, v in want_opt.items():
        close(got_opt[k], v, STEP_TOL, k)
    close(tst.sigma_state.data, jst.sigma_state.data, STEP_TOL, 'sigma data')
    close(tst.sigma_state.rmse, jst.sigma_state.rmse, STEP_TOL, 'sigma rmse')
