"""The checks of the named sections' twins (``torch_config_cases.
twin_config``) against the JAX package, shared by the parametrized
tests of ``test_torch_configs_eval.py`` and ``test_torch_configs_train*.
py``: ``evaluate`` in training and in per-class test mode within 5e-4, and
12 Adam steps of the section's optimizer from one init within 1e-4 (every
metric, parameter and the sigma state).  Batch 2, injected latent noise
in the L+1 layout, the weights carried across by ``save_load/from_jax``."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import unflatten_dict

import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.models.cvnet import CVNet as JCVNet
from joint_vae_tpu.ops.sigma import init_sigma_state
from joint_vae_tpu.train import optimizers as jopt
from joint_vae_tpu.train import steps as jsteps
from joint_vae_tpu.train.state import TrainState as JTrainState

from joint_vae_tpu_torch.models.cvnet import CVNet
from joint_vae_tpu_torch.models.evaluate import evaluate
from joint_vae_tpu_torch.ops.sigma import SigmaState
from joint_vae_tpu_torch.save_load.from_jax import state_dict_to_jax
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
from joint_vae_tpu_torch.train.state import create_train_state
from joint_vae_tpu_torch.train.steps import make_train_step

from torch_choices import Float64
from torch_config_cases import jax_config, twin_config
from torch_port_util import (close, inject_jax_eps, jax_arrays, make_eps,
                             port_cfg, port_model, port_sigma_state)

N = 2
EVAL_TOL, TRAIN_TOL, STEPS = 5e-4, 1e-4, 12


def one_thread(fn):
    """``fn`` on one torch thread, the caller's count restored after:
    the twins' ops are tiny, and with the default threads several test
    workers side by side spend their time in each other's spin-waits (six
    of these files at once ran 20 times slower)."""
    @functools.wraps(fn)
    def run(*a, **k):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*a, **k)
        finally:
            torch.set_num_threads(n)
    return run


@functools.lru_cache(maxsize=None)
def twin_job(section: str):
    """The section's twin and optimizer config, its JAX model and a
    TrainState carrying the weights of the port's init (seed 0) through
    ``state_dict_to_jax`` (the JAX layout and names, unflattened by path:
    a JAX init of a conv twin, even traced alone, takes seconds), the
    optimizer state from optax."""
    jcfg, jopt_cfg, _ = jax_config(section)
    jcfg = twin_config(jcfg)
    torch.manual_seed(0)
    arrays = state_dict_to_jax(CVNet(port_cfg(jcfg)))
    variables = unflatten_dict({tuple(k.split('/')): jnp.asarray(v)
                                for k, v in arrays.items()})
    params = variables['params']
    state = JTrainState(
        params=params, batch_stats=variables.get('batch_stats'),
        opt_state=jopt.build_optimizer(jopt_cfg).init(params),
        sigma_state=init_sigma_state(jcfg.sigma_cfg),
        rng=jax.random.PRNGKey(2), epoch=jnp.zeros((), jnp.int32),
        step=jnp.zeros((), jnp.int32))
    return jcfg, jopt_cfg, JCVNet(jcfg), state


def _batch(jcfg, rng):
    x = rng.uniform(0, 1, (N,) + tuple(jcfg.input_shape)).astype(np.float32)
    y = rng.integers(0, jcfg.num_labels, N).astype(np.int32)
    return x, y


@one_thread
def check_evaluate(section: str, train: bool, monkeypatch):
    """Training mode (labels, L of training, beta) or per-class test mode
    (no labels, test L): every loss, measure, the logits and the
    reconstructions."""
    jcfg, _, jmodel, jstate = twin_job(section)
    x, y = _batch(jcfg, np.random.default_rng(42))
    if not train:
        y = None
    L = jcfg.latent_sampling if train else jcfg.test_latent_sampling
    lead = (jcfg.num_labels, N) if jcfg.y_is_coded and y is None else (N,)
    eps = make_eps((L + 1,) + lead + (jcfg.latent_dim,))
    inject_jax_eps(monkeypatch, eps)
    has_bn = jcfg.has_batch_norm and train
    kw = dict(train=train, with_beta=train, return_bn_updates=has_bn)
    # jitted: one compile where an eager call compiles op by op (seconds)
    want = jax.jit(lambda v, xx, yy: jev.evaluate(
        jmodel, v, xx, yy, rng=jax.random.PRNGKey(1),
        sigma_state=jstate.sigma_state, **kw))(
            jstate.variables, jnp.asarray(x),
            None if y is None else jnp.asarray(y))
    with torch.no_grad():
        got = evaluate(port_model(jcfg, jstate), torch.from_numpy(x),
                       None if y is None else torch.from_numpy(y),
                       sigma_state=port_sigma_state(jstate),
                       eps=torch.from_numpy(eps), **kw)
    if has_bn:
        (want, wupd), (got, gupd) = want, got
        assert len(gupd) == len(jax.tree_util.tree_leaves(wupd)) // 2
    assert set(got.losses) == set(want.losses)
    for k, v in want.losses.items():
        assert tuple(got.losses[k].shape) == v.shape, k
        close(got.losses[k], v, EVAL_TOL, 'loss ' + k)
    assert set(got.measures) == set(want.measures)
    for k, v in want.measures.items():
        close(got.measures[k], v, EVAL_TOL, 'measure ' + k)
    if want.logits is not None:
        close(got.logits, want.logits, EVAL_TOL, 'logits')
    if want.x_reco is not None:
        close(got.x_reco, want.x_reco, EVAL_TOL, 'x_reco')


# sections whose 12 float32 steps are held in float64 on both sides (JAX
# with x64 on and its float32 casts taken as float64, the port's model and
# state in float64 under ``torch_choices.Float64``): in float32 they are
# rounding-limited, not port-limited.  [vgg-baseline]: training-mode
# BatchNorm after every conv leaves each conv bias's gradient zero but for
# rounding, which Adam's first steps scale up to lr.  [fashion-vgg16]:
# the JAX package sums var_kl = trace - log det - K over 1,024 variances
# near 1 in float32, whose ulp there (1.22e-4) is the tolerance.
FLOAT64_SECTIONS = ('vgg-baseline', 'fashion-vgg16')


def _f64(a):
    return (jnp.asarray(np.asarray(a), jnp.float64)
            if np.asarray(a).dtype == np.float32 else a)


@one_thread
def check_train_steps(section: str, monkeypatch):
    """12 steps of the section's optimizer from one init against JAX's
    ``make_train_step``."""
    jcfg, jopt_cfg, jmodel, jst = twin_job(section)
    f64 = section in FLOAT64_SECTIONS
    eps = make_eps((jcfg.latent_sampling + 1, N, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    model = port_model(jcfg, jst)
    sigma = port_sigma_state(jst)
    ocfg = OptimizerConfig(optim_type=jopt_cfg.optim_type, lr=jopt_cfg.lr)
    tx = jopt.build_optimizer(jopt_cfg)
    mode = contextlib.nullcontext()
    if f64:
        stack = contextlib.ExitStack()
        monkeypatch.setattr(jnp, 'float32', jnp.float64)
        stack.enter_context(jax.enable_x64(True))
        mode = stack
        params = jax.tree_util.tree_map(_f64, jst.params)
        jst = jst.replace(params=params, opt_state=tx.init(params),
                          batch_stats=jax.tree_util.tree_map(
                              _f64, jst.batch_stats),
                          sigma_state=jax.tree_util.tree_map(
                              _f64, jst.sigma_state))
        model = model.double()
        sigma = SigmaState(data=sigma.data.double(), rmse=sigma.rmse.double())
    with mode:
        jstep = jsteps.make_train_step(jmodel, tx, donate=False)
        with Float64() if f64 else contextlib.nullcontext():
            state = create_train_state(model, ocfg, sigma_state=sigma)
        step = make_train_step(model, ocfg)
        _run_steps(jcfg, jst, jstep, state, step, eps, f64)


def _run_steps(jcfg, jst, jstep, state, step, eps, f64):
    rng = np.random.default_rng(5)
    cast = (lambda a: a.double()) if f64 else (lambda a: a)
    for t in range(STEPS):
        x, y = _batch(jcfg, rng)
        jst, jm = jstep(jst, jnp.asarray(x, jnp.float64 if f64 else
                                         jnp.float32), jnp.asarray(y))
        with Float64() if f64 else contextlib.nullcontext():
            state, m = step(state, cast(torch.from_numpy(x)),
                            torch.from_numpy(y),
                            eps=cast(torch.from_numpy(eps)))
        assert set(m) == set(jm)
        for k, v in jm.items():
            close(m[k], v, TRAIN_TOL, 'step {} metric {}'.format(t, k))
    assert state.step == int(jst.step) == STEPS
    got = state_dict_to_jax(state.model)
    for k, v in jax_arrays(jst).items():
        close(got[k], v, TRAIN_TOL, k)
    close(state.sigma_state.data, jst.sigma_state.data, TRAIN_TOL,
          'sigma data')
