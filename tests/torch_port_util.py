"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: config translation, weight transfer and injected latent noise."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from joint_vae_tpu.save_load.checkpoint import flatten_pytree

from joint_vae_tpu_torch.models.cvnet import CVNet, CVNetConfig
from joint_vae_tpu_torch.ops.sigma import SigmaState
from joint_vae_tpu_torch.save_load.from_jax import jax_to_state_dict


def port_cfg(jcfg) -> CVNetConfig:
    """The port's config for a JAX CVNetConfig (through params.json form)."""
    d = dict(jcfg.architecture)
    d.update(beta=jcfg.beta, gamma=jcfg.gamma,
             latent_sampling=jcfg.latent_sampling, sigma=jcfg.sigma.params)
    return CVNetConfig.from_dict(d)


def jax_arrays(state) -> dict:
    """A JAX TrainState's checkpoint arrays (the state.npz keys)."""
    tree = {'params': state.params}
    if state.batch_stats is not None:
        tree['batch_stats'] = state.batch_stats
    return flatten_pytree(tree)


def port_model(jcfg, state) -> CVNet:
    """The port model carrying a JAX state's weights, in eval mode."""
    model = CVNet(port_cfg(jcfg))
    model.load_state_dict(jax_to_state_dict(model, jax_arrays(state)))
    return model.eval()


def port_sigma_state(state) -> SigmaState:
    return SigmaState(data=torch.tensor(np.asarray(state.sigma_state.data)),
                      rmse=torch.tensor(np.asarray(state.sigma_state.rmse)))


def make_eps(shape, seed=7) -> np.ndarray:
    """(L+1, ...) gaussian noise with row 0 zero (the ops/sampling layout)."""
    eps = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    eps[0] = 0.0
    return eps


def inject_jax_eps(monkeypatch, eps: np.ndarray):
    """Make JAX evaluate use ``eps`` as its (L+1, ...) latent noise."""
    import joint_vae_tpu.models.evaluate as ev

    def fake_reparameterize(key, mu, log_var, L, dist, sampled):
        e = jnp.asarray(eps)
        z = mu[None] + jnp.exp(0.5 * log_var)[None] * e * float(sampled)
        return z, e[1:]
    monkeypatch.setattr(ev, 'reparameterize', fake_reparameterize)


def close(got, want, tol, what=''):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


__all__ = ['port_cfg', 'jax_arrays', 'port_model', 'port_sigma_state',
           'make_eps', 'inject_jax_eps', 'close', 'jax']
