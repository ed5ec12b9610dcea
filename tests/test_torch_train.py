"""The port's training pieces against the JAX package, on the tiny flagship.

- the optimizer chain (adam, sgd with momentum and nesterov, clipping,
  weight decay) with the grad mask, a frozen module and the prior-mean
  thaw, against optax over 12 steps of numpy gradients: parameters and
  the optimizer state in the JAX key schema within 1e-6;
- the train step against JAX ``make_train_step`` over 12 steps from one
  shared init, with the same batches and the same injected noise:
  parameters, sigma state and every per-step metric within 1e-4 (the
  PARITY.md tolerance for optimizer trajectories);
- one BatchNorm train step (``batch_norm='both'``, learned sigma):
  running statistics and parameters within 1e-5;
- the eval step, and evaluate in training with ``bn_eval``, against JAX;
- the sigma rmse update and the warmup ramp against JAX; dropout by its
  statistics (keep rate, 1/(1-p) scale).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.ops import sigma as jsigma
from joint_vae_tpu.save_load.checkpoint import flatten_pytree
from joint_vae_tpu.save_load.jobs import new_job as jnew_job
from joint_vae_tpu.train import optimizers as jopt
from joint_vae_tpu.train import state as jstate
from joint_vae_tpu.train import steps as jsteps

import joint_vae_tpu_torch.models.evaluate as tev
from joint_vae_tpu_torch.models.layers import MLP, dropout
from joint_vae_tpu_torch.ops import sigma as tsigma
from joint_vae_tpu_torch.save_load.from_jax import (jax_to_state_dict,
                                                    opt_state_to_jax,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  build_optimizer)
from joint_vae_tpu_torch.train.state import (apply_grad_mask,
                                             create_train_state, grad_mask,
                                             named_params)
from joint_vae_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                             warmup_weight)

from torch_port_util import (close, inject_jax_eps, jax_arrays, make_eps,
                             port_model, port_sigma_state)

N = 6


def _tiny(**kw):
    """The tiny flagship (JAX config), with overrides."""
    return dataclasses.replace(graft._flagship_cfg(tiny=True), **kw)


def _port_grads(model, jgrads):
    """JAX-layout gradients -> the port's, by parameter name."""
    arrays = {'params/' + k: v for k, v in flatten_pytree(jgrads).items()}
    sd = jax_to_state_dict(model, arrays)
    return {k: sd[k] for k in named_params(model)}


OPT_CASES = {
    'adam': dict(optim_type='adam', lr=1e-2),
    'adam_clip_wd': dict(optim_type='adam', lr=1e-2, grad_clipping=30.0,
                         weight_decay=1e-2),
    'sgd': dict(optim_type='sgd', lr=0.05),
    'sgd_momentum': dict(optim_type='sgd', lr=0.05, momentum=0.9),
    'sgd_nesterov_clip_wd': dict(optim_type='sgd', lr=0.05, momentum=0.9,
                                 nesterov=True, grad_clipping=30.0,
                                 weight_decay=1e-2),
}


@pytest.mark.parametrize('name', sorted(OPT_CASES))
def test_optimizer_chain_matches_optax(name):
    """12 updates of numpy gradients through mask -> chain -> mask; the
    prior means thaw at epoch 3 (step 6); 'features' is frozen, so weight
    decay feeds its moments but never moves it."""
    kw = OPT_CASES[name]
    jcfg = _tiny()
    jcfg = dataclasses.replace(
        jcfg, prior=dataclasses.replace(jcfg.prior, freeze_means=3))
    job = jnew_job(jcfg, key=jax.random.PRNGKey(0))
    jmodel, params = job.model, job.state.params
    tx = jopt.build_optimizer(jopt.OptimizerConfig(**kw))
    ost = tx.init(params)
    jmask = jstate.grad_mask(jmodel, params, ('features',))

    model = port_model(jcfg, job.state)
    pcfg = OptimizerConfig(**kw)
    ptx = build_optimizer(pcfg)
    tparams = named_params(model)
    pst = ptx.init(tparams)
    pmask = grad_mask(model, ('features',))

    rng = np.random.default_rng(1)
    for t in range(12):
        epoch = t // 2
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)),
            params)
        gm = jstate.apply_grad_mask(jmodel, g, jmask, jnp.asarray(epoch))
        u, ost = tx.update(gm, ost, params)
        u = jstate.apply_grad_mask(jmodel, u, jmask, jnp.asarray(epoch))
        params = optax.apply_updates(params, u)

        gp = apply_grad_mask(model, _port_grads(model, g), pmask, epoch)
        up, pst = ptx.update(gp, pst, tparams)
        up = apply_grad_mask(model, up, pmask, epoch)
        with torch.no_grad():
            for k, v in up.items():
                tparams[k].add_(v)

    want = flatten_pytree({'params': params})
    got = state_dict_to_jax(model)
    for k, v in want.items():
        close(got[k], v, 1e-6, k)
    assert np.array_equal(got['params/features_stack/conv_0/kernel'],
                          jax_arrays(job.state)['params/features_stack/conv_0/kernel'])
    want_opt = flatten_pytree(ost)
    got_opt = opt_state_to_jax(model, pcfg, pst)
    assert set(got_opt) == set(want_opt)
    for k, v in want_opt.items():
        assert got_opt[k].dtype == v.dtype, k
        close(got_opt[k], v, 1e-6, k)


STEP_CASES = {
    'flagship_tiny': dict(cfg={}, opt=dict(lr=1e-3), warmup=(0, 0),
                          warmup_gamma=(0, 0)),
    'sigma_decay_clip_wd_warmup': dict(
        cfg=dict(sigma=jsigma.SigmaConfig(value=0.3, decay=0.1, reach=1.5,
                                          max_step=0.02)),
        opt=dict(lr=1e-3, grad_clipping=50.0, weight_decay=1e-3),
        warmup=(0, 3), warmup_gamma=(0, 1)),
}


def _batches(jcfg, n_steps, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (N,) + jcfg.input_shape).astype(np.float32),
             rng.integers(0, jcfg.num_labels, N).astype(np.int32))
            for _ in range(n_steps)]


def _port_setup(jcfg, jjob, opt_kw, warmup, warmup_gamma):
    model = port_model(jcfg, jjob.state)
    state = create_train_state(model, OptimizerConfig(**opt_kw),
                               sigma_state=port_sigma_state(jjob.state))
    return state, make_train_step(model, OptimizerConfig(**opt_kw), warmup,
                                  warmup_gamma)


@pytest.mark.parametrize('name', sorted(STEP_CASES))
def test_train_step_matches_jax_over_12_steps(name, monkeypatch):
    case = STEP_CASES[name]
    jcfg = _tiny(**case['cfg'])
    jjob = jnew_job(jcfg, jopt.OptimizerConfig(**case['opt']),
                    key=jax.random.PRNGKey(0))
    eps = make_eps((jcfg.latent_sampling + 1, N, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    jstep = jsteps.make_train_step(jjob.model, jopt.build_optimizer(jjob.opt_cfg),
                                   case['warmup'], case['warmup_gamma'],
                                   donate=False)
    state, step = _port_setup(jcfg, jjob, case['opt'], case['warmup'],
                              case['warmup_gamma'])
    jst = jjob.state
    for t, (x, y) in enumerate(_batches(jcfg, 12)):
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
    close(state.sigma_state.rmse, jst.sigma_state.rmse, 1e-4, 'sigma rmse')


def test_batchnorm_train_step_matches_jax(monkeypatch):
    """BatchNorm in both stacks takes batch statistics (biased variance
    over N, H, W) and moves its running averages by 0.01; one SGD step."""
    jcfg = _tiny(batch_norm='both',
                 sigma=jsigma.SigmaConfig(value=0.5, learned=True))
    opt = dict(optim_type='sgd', lr=0.05, momentum=0.9)
    jjob = jnew_job(jcfg, jopt.OptimizerConfig(**opt), key=jax.random.PRNGKey(2))
    assert jjob.state.batch_stats is not None
    eps = make_eps((2, N, jcfg.latent_dim), seed=9)
    inject_jax_eps(monkeypatch, eps)
    jstep = jsteps.make_train_step(jjob.model, jopt.build_optimizer(jjob.opt_cfg),
                                   donate=False)
    state, step = _port_setup(jcfg, jjob, opt, (0, 0), (0, 0))
    (x, y), = _batches(jcfg, 1, seed=8)
    jst, jm = jstep(jjob.state, jnp.asarray(x), jnp.asarray(y))
    state, m = step(state, torch.from_numpy(x), torch.from_numpy(y),
                    eps=torch.from_numpy(eps))
    got = state_dict_to_jax(state.model)
    want = jax_arrays(jst)
    assert any(k.startswith('batch_stats/imager/') for k in want)
    before = jax_arrays(jjob.state)
    for k, v in want.items():
        close(got[k], v, 1e-5, k)
        if k.startswith('batch_stats/'):
            assert not np.array_equal(v, before[k]), k
    close(m['total'], jm['total'], 1e-5, 'total')


@pytest.mark.parametrize('kw', [
    dict(value=0.3),
    dict(value=0.3, decay=0.1, reach=2.0, max_step=0.01),
    dict(value=0.3, decay=0.5),
    dict(is_rmse=True),
    dict(value=0.5, learned=True),
])
def test_update_sigma_rmse_matches_jax(kw):
    jcfg, tcfg = jsigma.SigmaConfig(**kw), tsigma.SigmaConfig(**kw)
    js = jsigma.init_sigma_state(jcfg)
    ts = tsigma.init_sigma_state(tcfg)
    for rmse in (0.25, 0.6, 0.05):
        js = jsigma.update_sigma_rmse(jcfg, js, jnp.float32(rmse))
        ts = tsigma.update_sigma_rmse(tcfg, ts, torch.tensor(rmse))
        close(ts.data, js.data, 1e-7, 'data')
        close(ts.rmse, js.rmse, 0, 'rmse')


@pytest.mark.parametrize('warmup', [(0, 0), (0, 3), (2, 4), (5, 0)])
def test_warmup_weight_matches_jax(warmup):
    for epoch in range(9):
        assert warmup_weight(epoch, warmup) == pytest.approx(
            float(jsteps.warmup_weight(jnp.asarray(epoch), warmup)), abs=1e-7)


def test_dropout_keep_rate_and_scale():
    """Elements survive with probability 1 - p, scaled by 1 / (1 - p)
    (flax ``nn.Dropout``); the mask comes from the generator; inference
    leaves the MLP deterministic; p = 1 drops everything."""
    n, p = 400_000, 0.3
    g = torch.Generator().manual_seed(0)
    y = dropout(torch.ones(n), p, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * math.sqrt(p * (1 - p) / n)
    close(y[kept], torch.full((int(kept.sum()),), 1 / (1 - p)), 1e-7)
    again = dropout(torch.ones(n), p, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    assert torch.count_nonzero(dropout(torch.ones(10), 1.0, g)) == 0

    mlp = MLP(8, (64,), dropout=0.5)
    x = torch.randn((4096, 8), generator=torch.Generator().manual_seed(1))
    ref = MLP(8, (64,))
    ref.load_state_dict(mlp.state_dict())
    assert torch.equal(mlp(x), ref(x))
    tr = mlp(x, train=True, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(tr, ref(x))
    # dropout after the activation keeps its mean in expectation
    assert abs(tr.mean().item() / ref(x).mean().item() - 1) < 0.02


def test_eval_step_matches_jax(monkeypatch):
    jcfg = _tiny()
    jjob = jnew_job(jcfg, key=jax.random.PRNGKey(3))
    eps = make_eps((jcfg.test_latent_sampling + 1, N, jcfg.latent_dim), seed=4)
    inject_jax_eps(monkeypatch, eps)
    (x, y), = _batches(jcfg, 1, seed=12)
    want = jsteps.make_eval_step(jjob.model, with_labels=True)(
        jjob.state.variables, jjob.state.sigma_state, jnp.asarray(x),
        jnp.asarray(y), jax.random.PRNGKey(0))
    got = make_eval_step(port_model(jcfg, jjob.state), with_labels=True)(
        port_sigma_state(jjob.state), torch.from_numpy(x), torch.from_numpy(y),
        eps=torch.from_numpy(eps))
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        close(got[0][k], v, 5e-4, 'loss ' + k)
    for g, w, what in zip(got[1:], want[1:], ('logits', 'mu', 'log_var')):
        close(g, w, 5e-4, what)


def test_bn_eval_keeps_running_stats(monkeypatch):
    """``bn_eval``: BatchNorm on its running statistics while the rest
    trains (the WIM semantics); no running update is returned."""
    jcfg = _tiny(batch_norm='both')
    jjob = jnew_job(jcfg, key=jax.random.PRNGKey(4))
    eps = make_eps((2, N, jcfg.latent_dim), seed=6)
    inject_jax_eps(monkeypatch, eps)
    (x, y), = _batches(jcfg, 1, seed=13)
    want, _ = jev.evaluate(jjob.model, jjob.state.variables, jnp.asarray(x),
                           jnp.asarray(y), rng=jax.random.PRNGKey(0),
                           sigma_state=jjob.state.sigma_state, train=True,
                           with_beta=True, bn_eval=True,
                           return_bn_updates=True)
    got, updates = tev.evaluate(port_model(jcfg, jjob.state),
                                torch.from_numpy(x), torch.from_numpy(y),
                                sigma_state=port_sigma_state(jjob.state),
                                train=True, with_beta=True, bn_eval=True,
                                return_bn_updates=True,
                                eps=torch.from_numpy(eps))
    assert updates == {}
    for k, v in want.losses.items():
        close(got.losses[k], v, 5e-4, k)
