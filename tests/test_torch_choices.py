"""``tests/torch_choices.py``: recording a forward's discrete choices (ReLU
masks, max-pool argmaxes, clamp sides, whole-tensor extremes) and imposing
them on another run, on the CPU.

- Recorded and replayed at the same input, a ``resnet18:8`` cvae (batch 64)
  and a vgg-style stack with max pools give the plain run's losses and
  gradients bit for bit, with no flip reported.
- A flip and its removal, each near-tie built on purpose: the first
  residual block's first ReLU input set to exactly 0 at one element
  through its BatchNorm bias, then the bias moved by one float32 ulp (the
  element turns on; batch 64); a max-pool window whose two largest inputs lie one ulp apart, then swapped
  by a one-ulp move.  Plain, the move takes a gradient beyond 1e-3
  (|ref| + rms(ref)); with the unmoved run's choices imposed it stays
  within 2e-5, and the report names the flipped element and its distance.
- The replayer raises on a choice count, kind or shape that does not
  match.
- What it records covers the gated paths: every piecewise function that
  a train step (``resnet18:8``, the vgg-style stack) or a WIM fine-tune
  step calls (``OpLister``) is one it imposes, or one named in
  ``UNRECORDED`` with the reason it needs none.
- Anchored to the JAX package: the ``resnet18:8`` cvae's first-step
  gradients at batch 64, JAX's float64 ``jax.grad`` against the port's own
  float64 gradients and against the port's float32 gradients with the
  port's float64 choices imposed, each within 1e-4 (|jax| + rms(jax)).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import __graft_entry__ as graft
import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.save_load.checkpoint import flatten_pytree
from joint_vae_tpu.train import optimizers as jopt

from joint_vae_tpu_torch.ft.wim import WIMJob
from joint_vae_tpu_torch.models.cvnet import flagship_config
from joint_vae_tpu_torch.models.evaluate import evaluate
from joint_vae_tpu_torch.ops.sigma import SigmaState
from joint_vae_tpu_torch.save_load.from_jax import jax_to_state_dict
from joint_vae_tpu_torch.save_load.jobs import new_job
from joint_vae_tpu_torch.train.optimizers import (OptimizerConfig,
                                                   build_optimizer)
from joint_vae_tpu_torch.train.state import named_params
from joint_vae_tpu_torch.train.steps import make_train_step

from torch_choices import ChoiceMismatch, Choices, Float64, OpLister
from torch_port_util import (inject_jax_eps, make_eps, port_model,
                             port_sigma_state)

GRAD_TOL = 1e-4          # chip_smoke.py's training gate
FLIP_MOVES = 1e-3        # a flip moves a gradient beyond this, plain
IMPOSED_TOL = 2e-5       # and leaves it within this, imposed
N_RESNET = 64
N_SMALL = 8

CONFIGS = {
    'resnet18:8': dict(features='resnet18:8'),
    'vgg_pools': dict(input_shape=(3, 16, 16),
                      features='[x3-Mx2]8-8-M-16-M-16-M-Ax1',
                      upsampler='[x4:2+1]16x4:1+0-8-8-!3x5:1+2'),
}


def _job(name, n, seed=0):
    """The tiny flagship with ``name``'s features on the CPU, and a batch
    of ``n`` with its labels and injected noise."""
    cfg = dataclasses.replace(flagship_config(tiny=True), **CONFIGS[name])
    job = new_job(cfg, OptimizerConfig(lr=1e-4), seed=1, device='cpu')
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (n,) + cfg.input_shape)
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, cfg.num_labels, n))
    eps = torch.from_numpy(make_eps((cfg.latent_sampling + 1, n,
                                     cfg.latent_dim), seed=seed + 7))
    return job, x, y, eps


def _forward(model, sigma_state, x, y, eps):
    out = evaluate(model, x, y, sigma_state=sigma_state, train=True,
                   with_beta=True, eps=eps)
    return torch.mean(out.losses['total'])


def _grads(model, sigma_state, x, y, eps):
    """The training loss and every parameter's gradient (the gate's first
    step)."""
    params = named_params(model)
    loss = _forward(model, sigma_state, x, y, eps)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss, {k: torch.zeros_like(p) if g is None else g
                  for (k, p), g in zip(params.items(), got)}


def _record(model, sigma_state, x, y, eps) -> Choices:
    choices = Choices()
    with torch.no_grad(), choices.recording():
        _forward(model, sigma_state, x, y, eps)
    return choices


def _worst(got: dict, want: dict) -> float:
    """max over tensors of |got - want| / (|want| + rms(want))."""
    worst = 0.0
    for k, w in want.items():
        w = torch.as_tensor(w).double()
        rms = w.square().mean().sqrt()
        worst = max(worst, ((got[k].double() - w).abs()
                            / (w.abs() + rms + 1e-300)).max().item())
    return worst


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_replay_at_the_same_input_is_bit_exact(name):
    job, x, y, eps = _job(name, N_RESNET if name == 'resnet18:8' else N_SMALL)
    loss, grads = _grads(job.model, job.sigma_state, x, y, eps)
    choices = _record(job.model, job.sigma_state, x, y, eps)
    kinds = choices.counts()['ops']
    assert kinds.get('relu', 0) >= 7 and kinds.get('max_pool2d', 0) >= 1
    with choices.imposing() as replay:
        loss2, grads2 = _grads(job.model, job.sigma_state, x, y, eps)
    assert replay.summary()['flips'] == 0
    assert torch.equal(loss, loss2)
    for k, g in grads.items():
        assert torch.equal(g, grads2[k]), k


def _relu_flip():
    """The resnet18:8 cvae at batch 64 with the first block's first ReLU
    input exactly 0 at the element of channel 0 nearest 0 (its BatchNorm
    bias set to minus the normalised value there): the gradients there,
    and those at the bias moved up by one ulp (the element turns on),
    plain and with the unmoved choices imposed.  Returns them, the
    replay and the element."""
    job, x, y, eps = _job('resnet18:8', N_RESNET, seed=2)
    model, sig = job.model, job.sigma_state
    bn = model.features_stack._BasicBlock_0.BatchNorm_0
    seen = []
    hook = bn.register_forward_hook(lambda m, a, out: seen.append(out))
    with torch.no_grad():
        bn.bias[0] = 0.0
        _forward(model, sig, x, y, eps)
        hook.remove()
        ch0 = seen[0][..., 0]
        element = np.unravel_index(int(ch0.abs().argmin()), ch0.shape)
        t = ch0[element].item()
        bn.bias[0] = -t
    _, base = _grads(model, sig, x, y, eps)
    choices = _record(model, sig, x, y, eps)
    with torch.no_grad():
        bn.bias[0] = float(np.nextafter(np.float32(-t), np.float32(np.inf)))
    _, plain = _grads(model, sig, x, y, eps)
    with choices.imposing() as replay:
        _, imposed = _grads(model, sig, x, y, eps)
    return base, plain, imposed, replay, tuple(int(i) for i in element) + (0,)


@pytest.fixture(scope='module')
def relu_flip():
    return _relu_flip()


def test_relu_flip_moves_gradients_and_imposing_removes_it(relu_flip):
    base, plain, imposed, *_ = relu_flip
    assert _worst(plain, base) > FLIP_MOVES
    assert _worst(imposed, base) <= IMPOSED_TOL


def _first_block_relu_site() -> str:
    """models/resnet.py:<line> of ``_BasicBlock.forward``'s first ReLU."""
    import inspect
    from joint_vae_tpu_torch.models.resnet import _BasicBlock
    lines, start = inspect.getsourcelines(_BasicBlock.forward)
    at = next(i for i, line in enumerate(lines)
              if 'torch.relu(self._bn(0,' in line)
    return 'models/resnet.py:{}'.format(start + at)


def test_near_tie_report_names_the_flipped_element(relu_flip):
    *_, replay, element = relu_flip
    site = _first_block_relu_site()
    built = [f for f in replay.flips
             if f.kind == 'relu' and f.site.endswith(site)]
    assert [f.element for f in built] == [element]
    assert 0 < built[0].distance <= 1e-6
    s = replay.summary()
    assert s['flips'] >= 1 and s['flips_by_kind']['relu'] >= 1
    assert s['worst_distance'] <= 1e-6


def _pool_net(x, w):
    """A max pool between two linear maps: y = w . pool(3 x)."""
    return (F.max_pool2d(3.0 * x, 2, 2) * w).sum()


def test_pool_flip_moves_gradients_and_imposing_removes_it():
    """A 2x2 window whose two largest inputs lie one ulp apart; the move
    swaps them (the gradient moves to the other element)."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 3, 4, 4)).astype(np.float32)
    x[1, 2, 0, 0] = 0.75
    x[1, 2, 0, 1] = np.nextafter(np.float32(0.75), np.float32(0))
    moved = x.copy()
    moved[1, 2, 0, 1] = np.nextafter(np.float32(0.75), np.float32(1))
    w = torch.from_numpy(rng.standard_normal((2, 3, 2, 2))
                         .astype(np.float32))

    def grad(a):
        t = torch.from_numpy(a).requires_grad_()
        return {'x': torch.autograd.grad(_pool_net(t, w), t)[0]}
    base = grad(x)
    choices = Choices()
    with torch.no_grad(), choices.recording():
        _pool_net(torch.from_numpy(x), w)
    assert _worst(grad(moved), base) > FLIP_MOVES
    with choices.imposing() as replay:
        imposed = grad(moved)
    assert _worst(imposed, base) <= IMPOSED_TOL
    assert [(f.kind, f.element) for f in replay.flips] == [
        ('max_pool2d', (1, 2, 0, 0))]
    assert 0 < replay.flips[0].distance <= 1e-6


@pytest.mark.parametrize('case', ['fewer', 'more', 'shape', 'kind'])
def test_replay_raises_on_a_mismatch(case):
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 3, 4, 4)).astype(np.float32))
    choices = Choices()
    with torch.no_grad(), choices.recording():
        F.max_pool2d(torch.relu(x), 2)
    with pytest.raises(ChoiceMismatch):
        with choices.imposing():
            if case == 'fewer':
                torch.relu(x)
            elif case == 'more':
                F.max_pool2d(torch.relu(torch.relu(x)), 2)
            elif case == 'shape':
                F.max_pool2d(torch.relu(x[:2]), 2)
            else:
                torch.relu(F.max_pool2d(x, 2))


# piecewise functions the recorder does not impose, each with the reason
# that it needs no imposing on these paths
UNRECORDED = {
    'argmax': "the train step's accuracy metric (detached: no gradient "
              "or loss reads it)",
    '__eq__': 'the same metric, argmax against the labels',
    'ge': "the sub-pixel deconv's tap masks, on integer indices "
          '(geometry, the same on every device)',
}
PIECEWISE = {
    'maximum', 'minimum', 'where', 'abs', 'sign', 'floor', 'ceil', 'round',
    'trunc', 'max', 'min', 'argmin', 'sort', 'argsort', 'topk', 'kthvalue',
    'median', 'hardtanh', 'relu6', 'threshold', 'clamp_min', 'clamp_max',
    'max_pool1d', 'max_pool3d', 'adaptive_max_pool2d', 'dropout', 'gt',
    'lt', 'ge', 'le', 'eq', 'ne', '__gt__', '__lt__', '__ge__', '__le__',
    '__eq__', '__ne__'} | set(UNRECORDED)


def _wim_step(job, x, y, eps):
    """One WIM fine-tuning step on ``job`` ([wim-default]'s alternate
    prior: an unconditional gaussian at mean 8)."""
    wim = WIMJob(job=job)
    wim.set_alternate_prior(seed=7, distribution='gaussian', init_mean=8.0,
                            num_priors=1)
    tx = build_optimizer(job.opt_cfg)
    job.state.opt_state = tx.init(named_params(job.model))
    wim.finetune_batch(job.state, x, y, x.flip(0), 0.1, tx=tx, eps=eps)


@pytest.mark.parametrize('path', ['resnet18:8', 'vgg_pools', 'wim'])
def test_recorded_kinds_cover_the_gated_steps(path):
    if path == 'wim':
        cfg = flagship_config(tiny=True)
        job = new_job(cfg, OptimizerConfig(lr=1e-4), seed=1, device='cpu')
        _, x, y, eps = _job('resnet18:8', N_SMALL)
        lister = OpLister()
        with lister:
            _wim_step(job, x, y, eps)
    else:
        job, x, y, eps = _job(path, N_SMALL)
        step = make_train_step(job.model, job.opt_cfg)
        lister = OpLister()
        with lister:
            step(job.state, x, y, eps=eps)
    seen = set(lister.seen)
    assert {'relu', 'clamp', 'amax', 'amin'} <= seen
    assert ('max_pool2d' in seen) == (path != 'wim')
    assert seen & PIECEWISE <= set(UNRECORDED), sorted(
        seen & PIECEWISE - set(UNRECORDED))


@pytest.fixture(scope='module')
def jax_float64_grads():
    """The resnet18:8 cvae's training-loss gradients at batch 64 from JAX in
    float64 (x64 on, the package's float32 casts taken as float64), and
    the port model carrying the same weights with the batch."""
    jcfg = dataclasses.replace(graft._flagship_cfg(tiny=True),
                               features='resnet18:8')
    jjob = jjobs.new_job(jcfg, jopt.OptimizerConfig(lr=1e-3),
                         key=jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (N_RESNET, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, jcfg.num_labels, N_RESNET).astype(np.int32)
    eps = make_eps((jcfg.latent_sampling + 1, N_RESNET, jcfg.latent_dim))
    f64 = lambda a: (jnp.asarray(np.asarray(a), jnp.float64)   # noqa: E731
                     if np.asarray(a).dtype == np.float32 else a)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        inject_jax_eps(mp, eps)
        mp.setattr(jnp, 'float32', jnp.float64)
        variables = jax.tree_util.tree_map(f64, jjob.state.variables)
        sigma = jax.tree_util.tree_map(f64, jjob.state.sigma_state)

        def loss(params):
            out, _ = jev.evaluate(
                jjob.model, {**variables, 'params': params},
                jnp.asarray(x, jnp.float64), jnp.asarray(y),
                rng=jax.random.PRNGKey(1), sigma_state=sigma, train=True,
                with_beta=True, return_bn_updates=True)
            return jnp.mean(out.losses['total'])
        jgrads = jax.grad(loss)(variables['params'])
        jgrads = {'params/' + k: np.asarray(v)
                  for k, v in flatten_pytree(jgrads).items()}
    assert {v.dtype for v in jgrads.values()} == {np.dtype(np.float64)}
    model = port_model(jcfg, jjob.state)
    want = jax_to_state_dict(model, jgrads)
    batch = (torch.from_numpy(x), torch.from_numpy(y).long(),
             torch.from_numpy(eps))
    return want, model, port_sigma_state(jjob.state), batch


@pytest.mark.parametrize('run', ['port_float64', 'port_float32_imposed'])
def test_resnet_cvae_gradients_match_jax_float64(jax_float64_grads, run):
    want, model, sigma, (x, y, eps) = jax_float64_grads
    m64 = copy.deepcopy(model).double()
    sig64 = SigmaState(data=sigma.data.double(), rmse=sigma.rmse.double())
    choices = Choices()
    with Float64(), choices.recording():
        _, got = _grads(m64, sig64, x.double(), y, eps.double())
    if run == 'port_float32_imposed':
        with choices.imposing():
            _, got = _grads(model, sigma, x, y, eps)
    assert set(got) <= set(want)
    assert _worst(got, {k: want[k] for k in got}) <= GRAD_TOL
