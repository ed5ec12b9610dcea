"""The port's second geometry, imagenet64 (``__graft_entry__._imagenet64_cfg``:
a cvae with vgg16 features on 3x64x64, a [x4:2+1] sub-pixel upsampler with
a 5x5 head, widths 2048, K=256, a learned 1000-class gaussian prior, test
L=16), against the JAX package on the CPU:

- ``imagenet64_config`` equals the JAX config in both dtypes;
- the full-width model (40,566,355 parameters) at batch 2, L=16, with and
  without labels, with injected latent noise: ``evaluate``'s losses,
  logits, reconstructions and measures within 5e-4 (docs/PARITY.md);
- the weight bridge carries its vgg16 weights both ways bit for bit;
- the full-width training loss at batch 2 (L=1, labels): every
  parameter's gradient against ``jax.grad``'s in the training gate's form,
  |got - want| <= 1e-4 (|want| + rms(want));
- a narrowed twin with the same layer kinds (a vgg-style [x3-Mx2] trunk
  with max pools and the final Ax1, a [x4:2+1] sub-pixel upsampler with
  a 5x5 head, a learned conditional prior) trained 12 Adam steps from one
  init against JAX ``make_train_step``: every metric, parameter and the
  sigma state within 1e-4 (the optimizer trajectories' tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.ops.priors import PriorConfig as JPriorConfig
from joint_vae_tpu.save_load.checkpoint import flatten_pytree
from joint_vae_tpu.save_load.jobs import new_job as jnew_job
from joint_vae_tpu.train import optimizers as jopt
from joint_vae_tpu.train import steps as jsteps

from joint_vae_tpu_torch.models.cvnet import CVNet, imagenet64_config
from joint_vae_tpu_torch.models.evaluate import evaluate
from joint_vae_tpu_torch.save_load.from_jax import (jax_to_state_dict,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
from joint_vae_tpu_torch.train.state import create_train_state, named_params
from joint_vae_tpu_torch.train.steps import make_train_step

from torch_port_util import (close, inject_jax_eps, jax_arrays, make_eps,
                             port_cfg, port_model, port_sigma_state)

N_EVAL = 2
N_TWIN = 6
PARAMS = 40566355


@pytest.fixture(scope='module')
def full_job():
    """The JAX package's full-width imagenet64 job (its init takes most of
    this file's time, so its cases share it)."""
    return jnew_job(graft._imagenet64_cfg(), key=jax.random.PRNGKey(0))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_imagenet64_config_matches(dtype):
    jcfg = graft._imagenet64_cfg(compute_dtype=dtype)
    assert imagenet64_config(dtype).architecture == jcfg.architecture
    assert port_cfg(jcfg) == imagenet64_config(dtype)


def test_imagenet64_routes_and_size():
    """Every vgg16 conv and the head on the same-grid kernel, the four
    stride-2 deconvs on its sub-pixel route: 18 launches a forward."""
    model = CVNet(imagenet64_config())
    assert sum(p.numel() for p in model.parameters()) == PARAMS
    feats = [m.route for _, m in model.features_stack.conv_layers()]
    assert feats == ['same_grid'] * 13
    assert [m.route for _, m in model.imager.conv_layers()] == \
        ['matmul'] + ['subpixel'] * 4 + ['same_grid']


@pytest.mark.parametrize('with_labels', [False, True])
def test_imagenet64_evaluate_matches_jax(full_job, with_labels, monkeypatch):
    jcfg = graft._imagenet64_cfg()
    L = jcfg.test_latent_sampling
    x = np.random.default_rng(42).uniform(
        0, 1, (N_EVAL,) + jcfg.input_shape).astype(np.float32)
    y = (np.random.default_rng(4).integers(0, jcfg.num_labels, N_EVAL)
         if with_labels else None)
    eps = make_eps((L + 1, N_EVAL, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    want = jev.evaluate(full_job.model, full_job.state.variables,
                        jnp.asarray(x), None if y is None else jnp.asarray(y),
                        rng=jax.random.PRNGKey(1),
                        sigma_state=full_job.state.sigma_state, train=False)
    model = port_model(jcfg, full_job.state)
    with torch.no_grad():
        got = evaluate(model, torch.from_numpy(x),
                       None if y is None else torch.from_numpy(y),
                       sigma_state=port_sigma_state(full_job.state),
                       eps=torch.from_numpy(eps))
    assert set(got.losses) == set(want.losses)
    for k, v in want.losses.items():
        assert tuple(got.losses[k].shape) == v.shape, k
        close(got.losses[k], v, 5e-4, 'loss ' + k)
    assert tuple(got.logits.shape) == (N_EVAL, jcfg.num_labels)
    close(got.logits, want.logits, 5e-4, 'logits')
    close(got.x_reco, want.x_reco, 5e-4, 'x_reco')
    assert set(got.measures) == set(want.measures)
    for k, v in want.measures.items():
        close(got.measures[k], v, 5e-4, 'measure ' + k)


def test_imagenet64_weights_round_trip_bit_exact(full_job):
    arrays = jax_arrays(full_job.state)
    model = port_model(graft._imagenet64_cfg(), full_job.state)
    back = state_dict_to_jax(model)
    assert set(back) == set(arrays)
    assert sum(v.size for k, v in arrays.items()
               if k.startswith('params/')) == PARAMS
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def _twin_cfg():
    """imagenet64's layer kinds at a few layers and narrow widths."""
    return dataclasses.replace(
        graft._imagenet64_cfg(), input_shape=(3, 16, 16), num_labels=10,
        features='[x3-Mx2]8-8-M-16-M-16-M-Ax1',
        upsampler='[x4:2+1]16x4:1+0-8-8-!3x5:1+2',
        encoder=(32,), decoder=(32,), latent_dim=16, test_latent_sampling=4,
        gamma=100.0, prior=JPriorConfig(dim=16, num_priors=10, init_mean=1.0,
                                        learned_means=True))


def test_imagenet64_twin_routes():
    """The twin takes the full model's routes: every trunk conv and the
    head on the same-grid kernel, the deconvs on the sub-pixel route."""
    model = CVNet(port_cfg(_twin_cfg()))
    assert [m.route for _, m in model.features_stack.conv_layers()] == \
        ['same_grid'] * 4
    assert [m.route for _, m in model.imager.conv_layers()] == \
        ['matmul', 'subpixel', 'subpixel', 'same_grid']


def test_imagenet64_twin_train_step_matches_jax_over_12_steps(monkeypatch):
    jcfg = _twin_cfg()
    opt = dict(lr=1e-3)
    jjob = jnew_job(jcfg, jopt.OptimizerConfig(**opt),
                    key=jax.random.PRNGKey(0))
    eps = make_eps((jcfg.latent_sampling + 1, N_TWIN, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    jstep = jsteps.make_train_step(jjob.model,
                                   jopt.build_optimizer(jjob.opt_cfg),
                                   donate=False)
    model = port_model(jcfg, jjob.state)
    state = create_train_state(model, OptimizerConfig(**opt),
                               sigma_state=port_sigma_state(jjob.state))
    step = make_train_step(model, OptimizerConfig(**opt))
    rng = np.random.default_rng(5)
    jst = jjob.state
    for t in range(12):
        x = rng.uniform(0, 1, (N_TWIN,) + jcfg.input_shape).astype(np.float32)
        y = rng.integers(0, jcfg.num_labels, N_TWIN).astype(np.int32)
        jst, jm = jstep(jst, jnp.asarray(x), jnp.asarray(y))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y),
                        eps=torch.from_numpy(eps))
        assert set(m) == set(jm)
        for k, v in jm.items():
            close(m[k], v, 1e-4, 'step {} metric {}'.format(t, k))
    assert state.step == int(jst.step) == 12
    got = state_dict_to_jax(state.model)
    for k, v in jax_arrays(jst).items():
        close(got[k], v, 1e-4, k)
    close(state.sigma_state.data, jst.sigma_state.data, 1e-4, 'sigma data')


def test_imagenet64_first_step_gradients_match_jax(full_job, monkeypatch):
    """The full-width model's training loss at batch 2 (L=1, labels, the
    same injected noise): every parameter's gradient against JAX's in the
    training gate's form, |got - want| <= 1e-4 (|want| + rms(want))."""
    jcfg = graft._imagenet64_cfg()
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (N_EVAL,) + jcfg.input_shape).astype(np.float32)
    y = rng.integers(0, jcfg.num_labels, N_EVAL).astype(np.int32)
    eps = make_eps((jcfg.latent_sampling + 1, N_EVAL, jcfg.latent_dim), seed=9)
    inject_jax_eps(monkeypatch, eps)
    variables = full_job.state.variables

    def loss(params):
        out = jev.evaluate(full_job.model, {**variables, 'params': params},
                           jnp.asarray(x), jnp.asarray(y),
                           rng=jax.random.PRNGKey(1),
                           sigma_state=full_job.state.sigma_state, train=True,
                           with_beta=True)
        return jnp.mean(out.losses['total'])
    jgrads = jax.grad(loss)(variables['params'])
    model = port_model(jcfg, full_job.state)
    want = jax_to_state_dict(model, {'params/' + k: v for k, v in
                                     flatten_pytree(jgrads).items()})
    params = named_params(model)
    out = evaluate(model, torch.from_numpy(x), torch.from_numpy(y),
                   sigma_state=port_sigma_state(full_job.state), train=True,
                   with_beta=True, eps=torch.from_numpy(eps))
    got = torch.autograd.grad(torch.mean(out.losses['total']),
                              list(params.values()), allow_unused=True)
    assert len(got) == len(params) and set(params) <= set(want)
    for (k, p), g in zip(params.items(), got):
        w = torch.as_tensor(want[k])
        g = torch.zeros_like(p) if g is None else g
        rms = w.square().mean().sqrt().item()
        ratio = ((g - w).abs() / (w.abs() + rms + 1e-30)).max().item()
        assert ratio <= 1e-4, (k, ratio)
