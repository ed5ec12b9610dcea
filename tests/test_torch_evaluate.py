"""The port's ``evaluate(train=False)`` against the JAX package for all five
types on tiny configs (the flagship's tiny twin included), with and without
labels, with injected latent noise: losses, logits, reconstructions and
measures within 5e-4 (docs/PARITY.md)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.models.cvnet import CVNetConfig as JCVNetConfig
from joint_vae_tpu.ops.priors import build_prior_config
from joint_vae_tpu.ops.sigma import SigmaConfig as JSigmaConfig
from joint_vae_tpu.save_load.jobs import new_job as jnew_job

from joint_vae_tpu_torch.models.evaluate import evaluate

from torch_port_util import (close, inject_jax_eps, make_eps, port_model,
                             port_sigma_state)


def _cfg(type_, **kw):
    base = dict(input_shape=(1, 6, 6), num_labels=3, type=type_,
                encoder=(16,), decoder=(16,), classifier=(8,), latent_dim=4,
                latent_sampling=2, test_latent_sampling=3, gamma=10.0,
                beta=1e-2, sigma=JSigmaConfig(value=0.3),
                prior=build_prior_config(4, 'gaussian', num_priors=3,
                                         init_mean=1.0, learned_means=True))
    base.update(kw)
    return JCVNetConfig(**base)


EVAL_CFGS = {
    'flagship_tiny': lambda: graft._flagship_cfg(tiny=True),
    'cvae_lme_diag_dense': lambda: _cfg(
        'cvae', iws_mode='lme',
        prior=build_prior_config(4, 'gaussian', num_priors=3, var_dim='diag',
                                 init_mean=1.0)),
    'cvae_bn_hsv_learned_sigma': lambda: _cfg(
        'cvae', input_shape=(3, 8, 8), features='[x3+1]6-6:2',
        upsampler='[x3+1]6x2+0-6:2++1-!3x3+1', decoder=(54,), batch_norm='both',
        representation='hsv', sigma=JSigmaConfig(value=0.5, learned=True)),
    'cvae_categorical_rmse': lambda: _cfg(
        'cvae', output_distribution='categorical',
        sigma=JSigmaConfig(is_rmse=True)),
    'vae': lambda: _cfg('vae', prior=None),
    'jvae': lambda: _cfg('jvae', prior=None),
    'xvae_tilted': lambda: _cfg(
        'xvae', prior=build_prior_config(4, 'tilted', num_priors=3,
                                         init_mean=1.0, tau=2.0)),
    'vib': lambda: _cfg('vib', prior=None),
    'cvae_uniform': lambda: _cfg(
        'cvae', prior=build_prior_config(4, 'uniform', num_priors=3,
                                         init_mean=1.0, tau=1.5)),
}


@pytest.mark.parametrize('with_labels', [False, True])
@pytest.mark.parametrize('name', sorted(EVAL_CFGS))
def test_evaluate_matches_jax(name, with_labels, monkeypatch):
    jcfg = EVAL_CFGS[name]()
    job = jnew_job(jcfg, key=jax.random.PRNGKey(0))
    if jcfg.has_batch_norm:
        rng_bn = np.random.default_rng(2)
        job.state = job.state.replace(batch_stats=jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + rng_bn.uniform(
                0.1, 0.4, a.shape).astype(np.float32)), job.state.batch_stats))
    N = 5
    L = jcfg.test_latent_sampling
    x = np.random.default_rng(42).uniform(
        0, 1, (N,) + jcfg.input_shape).astype(np.float32)
    y = (np.random.default_rng(4).integers(0, jcfg.num_labels, N)
         if with_labels else None)
    x_rep = jcfg.y_is_coded and y is None
    lead = (jcfg.num_labels, N) if x_rep else (N,)
    eps = make_eps((L + 1,) + lead + (jcfg.latent_dim,))
    inject_jax_eps(monkeypatch, eps)
    want = jev.evaluate(job.model, job.state.variables, jnp.asarray(x),
                        None if y is None else jnp.asarray(y),
                        rng=jax.random.PRNGKey(1),
                        sigma_state=job.state.sigma_state, train=False)
    model = port_model(jcfg, job.state)
    got = evaluate(model, torch.from_numpy(x),
                   None if y is None else torch.from_numpy(y),
                   sigma_state=port_sigma_state(job.state),
                   eps=torch.from_numpy(eps))
    assert set(got.losses) == set(want.losses)
    for k, v in want.losses.items():
        assert tuple(got.losses[k].shape) == v.shape, k
        close(got.losses[k], v, 5e-4, 'loss ' + k)
    close(got.logits, want.logits, 5e-4, 'logits')
    close(got.x_reco, want.x_reco, 5e-4, 'x_reco')
    assert set(got.measures) == set(want.measures)
    for k, v in want.measures.items():
        close(got.measures[k], v, 5e-4, 'measure ' + k)


def test_decode_mean_false_skips_sample_zero(monkeypatch):
    jcfg = graft._flagship_cfg(tiny=True)
    job = jnew_job(jcfg, key=jax.random.PRNGKey(3))
    eps = make_eps((3, 4, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    x = np.random.default_rng(0).uniform(0, 1, (4, 3, 8, 8)).astype(np.float32)
    want = jev.evaluate(job.model, job.state.variables, jnp.asarray(x), None,
                        rng=jax.random.PRNGKey(1),
                        sigma_state=job.state.sigma_state, train=False,
                        decode_mean=False)
    got = evaluate(port_model(jcfg, job.state), torch.from_numpy(x),
                   sigma_state=port_sigma_state(job.state),
                   eps=torch.from_numpy(eps), decode_mean=False)
    assert tuple(got.x_reco.shape) == want.x_reco.shape == (2, 4, 3, 8, 8)
    for k, v in want.losses.items():
        close(got.losses[k], v, 5e-4, k)
