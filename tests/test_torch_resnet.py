"""The port's ResNet/DenseNet trunks and pretrained transfer against the
JAX package, at small widths:

- each trunk's forward (``resnet18:8``, ``resnet50:4``, ``densenet-tiny:4``
  and the torchvision ``densenet121:8``, on 32x32) in inference within
  1e-4 (|jax| + rms(jax)) elementwise in float32, and in training (batch
  statistics) with the running statistics it records, within the same
  bound in float64 on both sides.  In float32 a training forward of these
  narrow trunks is ill-conditioned: each BatchNorm divides by the spread
  of a few dozen values, and JAX's own float32 forward lies up to 4e-3
  (|x| + rms) from its float64 one for ``resnet50:4`` (the port's 3e-4,
  with no ReLU or max-pool choice differing from float64's), so the two
  float32 forwards are not held to each other at 1e-4; in float64 the
  comparison shows the semantics (flax's biased variance, momentum,
  epsilon, -inf max-pool padding, floor average pooling).  Float32
  training gradients are held: a ``resnet18:8`` cvae's at batch 64 lie
  within 1e-4 (|jax| + rms) of JAX's float64 ``jax.grad`` once the port's
  float64 ReLU and max-pool choices are imposed
  (``tests/test_torch_choices.py``);
- the tree: every JAX array path maps to a port tensor, and
  ``from_jax`` both ways returns the same bits (weights, BatchNorm
  statistics, optimizer state);
- a ``resnet18:8`` cvae: ``evaluate`` per class and in training within
  5e-4, and 12 train steps against JAX's ``train_step`` within 1e-4
  (parameters, running statistics, every metric) at batch 64.  On 8x8
  inputs the trunk's last two stages work on 1x1 maps, so their batch
  statistics are taken over the batch alone; at batch 6 the trajectory is
  chaotic: JAX against itself, with inputs one float32 ulp apart, parts
  by 3,900 times the tolerance on ``grad_norm`` within 12 steps (0.04 at
  batch 64);
- ``transfer_pretrained``: the same frozen set as JAX's and no update to
  a frozen parameter; ``cli.train --pretrained-features`` no longer
  refused;
- the torchvision DenseNet's too-small-input error; the full-width
  parameter counts;
- one bfloat16 case under ``tests/test_torch_bf16.py``'s gate.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from joint_vae_tpu.models import resnet as jresnet
from joint_vae_tpu.models import evaluate as jev
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.save_load.checkpoint import flatten_pytree
from joint_vae_tpu.save_load.transfer import transfer_pretrained as jtransfer
from joint_vae_tpu.train import optimizers as jopt
from joint_vae_tpu.train import steps as jsteps

import joint_vae_tpu_torch.models.evaluate as tev
from joint_vae_tpu_torch.cli.train import main as train_main
from joint_vae_tpu_torch.models import resnet as tresnet
from joint_vae_tpu_torch.models.conv import apply_bn_updates
from joint_vae_tpu_torch.models.cvnet import CVNet
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.from_jax import (jax_to_opt_state,
                                                    jax_to_state_dict,
                                                    opt_state_to_jax,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.save_load.transfer import transfer_pretrained
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
from joint_vae_tpu_torch.train.state import create_train_state
from joint_vae_tpu_torch.train.steps import make_train_step

from test_torch_bf16 import gate
from torch_port_util import (close, inject_jax_eps, jax_arrays, make_eps,
                             port_cfg, port_model, port_sigma_state)

TRUNK_TOL = 1e-4
EVAL_TOL = 5e-4
TRAIN_TOL = 1e-4
N = 6
N_STEP = 64

TRUNKS = {
    'resnet18:8': (lambda: jresnet.ResNetFeatures(arch='resnet18', width=8),
                   lambda: tresnet.ResNetFeatures('resnet18', width=8)),
    'resnet50:4': (lambda: jresnet.ResNetFeatures(arch='resnet50', width=4),
                   lambda: tresnet.ResNetFeatures('resnet50', width=4)),
    'densenet-tiny:4': (
        lambda: jresnet.DenseNetFeatures(arch='densenet-tiny', growth=4),
        lambda: tresnet.DenseNetFeatures('densenet-tiny', growth=4)),
    'densenet121:8': (
        lambda: jresnet.DenseNetFeatures(arch='densenet121', growth=8),
        lambda: tresnet.DenseNetFeatures('densenet121', growth=8)),
}


def trunk_close(got, want, what):
    """|got - want| <= TRUNK_TOL (|want| + rms(want)) elementwise."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bound = TRUNK_TOL * (np.abs(want) + np.sqrt(np.mean(want ** 2)))
    worst = np.max(np.abs(got - want) - bound)
    assert worst <= 0, '{}: exceeds the bound by {:.3e}'.format(what, worst)


def _random_trunk(name, seed=0):
    """The port trunk with random weights and running statistics, its JAX
    twin and the JAX variables holding the same values."""
    jm, tm = TRUNKS[name][0](), TRUNKS[name][1]()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for pname, t in tm.state_dict().items():
            if pname.endswith('running_var'):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
            elif pname.endswith('weight') and t.ndim == 4:
                fan_in = t.shape[1] * t.shape[2] * t.shape[3]
                t.copy_(torch.from_numpy(rng.standard_normal(t.shape)
                                         / np.sqrt(fan_in)))
            else:
                base = 1.0 if pname.endswith('weight') else 0.0
                t.copy_(torch.from_numpy(
                    base + 0.1 * rng.standard_normal(t.shape)))
    arrays = state_dict_to_jax(tm)
    variables = flax.traverse_util.unflatten_dict(
        {tuple(k.split('/')): jnp.asarray(v) for k, v in arrays.items()})
    return jm, tm, variables


def _snapshot(model):
    """A copy of the model's arrays (``state_dict_to_jax`` may share the
    parameters' memory)."""
    return {k: v.copy() for k, v in state_dict_to_jax(model).items()}


def _x(n, seed=1, hw=32):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 3, hw, hw)).astype(np.float32)


@pytest.mark.parametrize('name', sorted(TRUNKS))
def test_trunk_tree_matches_jax_init(name):
    """The port's tensors are exactly the JAX init's arrays, by path and
    shape, and the output shape is the module's ``output_shape``."""
    jm, tm = TRUNKS[name][0](), TRUNKS[name][1]()
    x = jnp.zeros((1, 3, 32, 32))
    out, shapes = jax.eval_shape(jm.init_with_output, jax.random.PRNGKey(0), x)
    want = {'/'.join(k): v.shape for k, v in
            flax.traverse_util.flatten_dict(dict(shapes)).items()}
    got = {k: v.shape for k, v in state_dict_to_jax(tm).items()}
    assert got == want
    assert tuple(out.shape[1:]) == tm.output_shape == jm.output_shape


@pytest.mark.parametrize('name', sorted(TRUNKS))
def test_trunk_inference_forward_matches_jax(name):
    jm, tm, variables = _random_trunk(name)
    x = _x(4)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    trunk_close(tm(torch.from_numpy(x)), want, name)


@pytest.mark.parametrize('name', sorted(TRUNKS))
def test_trunk_training_forward_matches_jax_float64(name):
    """Batch statistics and the running statistics recorded, float64 on
    both sides (flax keeps float64 statistics in float64, as the port's
    BatchNorm does)."""
    jm, tm, variables = _random_trunk(name)
    x = _x(8)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        j64 = jm.clone(dtype=jnp.float64)
        want, upd = jax.jit(lambda v, xx: j64.apply(
            v, xx, train=True, mutable=['batch_stats']))(
                v64, jnp.asarray(x, jnp.float64))
        want = np.asarray(want)
        stats = {'batch_stats/' + '/'.join(k): np.asarray(v) for k, v in
                 flax.traverse_util.flatten_dict(
                     dict(upd['batch_stats'])).items()}
    tm = tm.double()
    tm.dtype = torch.float64
    updates = {}
    got = tm(torch.from_numpy(x).double(), True, updates)
    trunk_close(got, want, name)
    assert len(updates) == len(stats) // 2
    apply_bn_updates(updates)
    arrays = state_dict_to_jax(tm)
    for k, v in stats.items():
        trunk_close(arrays[k], v, k)


def _resnet_cfg(features='resnet18:8', **kw):
    """The tiny flagship with a trunk for features."""
    return dataclasses.replace(graft._flagship_cfg(tiny=True),
                               features=features, **kw)


@pytest.mark.parametrize('features', ['resnet18:8', 'densenet-tiny:4'])
def test_from_jax_both_ways_bit_exact(features):
    """A JAX job's weights, BatchNorm statistics and Adam state through
    the port and back: the same bits; a port save loads in JAX."""
    jcfg = _resnet_cfg(features)
    jjob = jjobs.new_job(jcfg, jopt.OptimizerConfig(lr=1e-3),
                         key=jax.random.PRNGKey(0))
    tx = jopt.build_optimizer(jjob.opt_cfg)
    step = jsteps.make_train_step(jjob.model, tx, donate=False)
    x = _x(N, hw=8)
    y = np.arange(N, dtype=np.int32) % 4
    st, _ = step(jjob.state, jnp.asarray(x), jnp.asarray(y))
    arrays = jax_arrays(st)
    assert any(k.startswith('batch_stats/features_stack/') for k in arrays)
    model = CVNet(port_cfg(jcfg))
    model.load_state_dict(jax_to_state_dict(model, arrays))
    back = state_dict_to_jax(model)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert np.array_equal(back[k], np.asarray(v)), k
    jopt_arrays = flatten_pytree(st.opt_state)
    tcfg = OptimizerConfig(lr=1e-3)
    state = create_train_state(model, tcfg)
    jax_to_opt_state(model, tcfg, jopt_arrays, state.opt_state)
    got = opt_state_to_jax(model, tcfg, state.opt_state)
    assert set(got) == set(jopt_arrays)
    for k, v in jopt_arrays.items():
        assert np.array_equal(got[k], np.asarray(v)), k


@pytest.fixture(scope='module')
def resnet_job():
    jcfg = _resnet_cfg()
    return jcfg, jjobs.new_job(jcfg, jopt.OptimizerConfig(lr=1e-3),
                               key=jax.random.PRNGKey(0))


@pytest.mark.parametrize('train', [False, True], ids=['per_class', 'train'])
def test_resnet_cvae_evaluate_matches_jax(resnet_job, train, monkeypatch):
    jcfg, jjob = resnet_job
    x = _x(N, seed=3, hw=8)
    y = np.arange(N, dtype=np.int32) % 4 if train else None
    L = 1 if train else jcfg.test_latent_sampling
    eps = make_eps((L + 1, N, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    kw = dict(train=train, with_beta=train)
    want = jev.evaluate(jjob.model, jjob.state.variables, jnp.asarray(x),
                        None if y is None else jnp.asarray(y),
                        rng=jax.random.PRNGKey(0),
                        sigma_state=jjob.state.sigma_state,
                        return_bn_updates=train, **kw)
    got = tev.evaluate(port_model(jcfg, jjob.state), torch.from_numpy(x),
                       None if y is None else torch.from_numpy(y),
                       sigma_state=port_sigma_state(jjob.state),
                       eps=torch.from_numpy(eps),
                       return_bn_updates=train, **kw)
    if train:
        (want, wupd), (got, gupd) = want, got
        assert len(gupd) == len(jax.tree_util.tree_leaves(wupd)) // 2
    assert set(got.losses) == set(want.losses)
    for k, v in want.losses.items():
        close(got.losses[k], v, EVAL_TOL, 'loss ' + k)
    for k, v in want.measures.items():
        close(got.measures[k], v, EVAL_TOL, 'measure ' + k)
    close(got.logits, want.logits, EVAL_TOL, 'logits')


def test_resnet_cvae_train_step_matches_jax_over_12_steps(resnet_job,
                                                           monkeypatch):
    jcfg, jjob = resnet_job
    eps = make_eps((jcfg.latent_sampling + 1, N_STEP, jcfg.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    jstep = jsteps.make_train_step(jjob.model,
                                   jopt.build_optimizer(jjob.opt_cfg),
                                   donate=False)
    model = port_model(jcfg, jjob.state)
    ocfg = OptimizerConfig(lr=1e-3)
    state = create_train_state(model, ocfg,
                               sigma_state=port_sigma_state(jjob.state))
    step = make_train_step(model, ocfg)
    rng = np.random.default_rng(5)
    jst = jjob.state
    for t in range(12):
        x = rng.uniform(0, 1, (N_STEP, 3, 8, 8)).astype(np.float32)
        y = rng.integers(0, 4, N_STEP).astype(np.int32)
        jst, jm = jstep(jst, jnp.asarray(x), jnp.asarray(y))
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y),
                        eps=torch.from_numpy(eps))
        assert set(m) == set(jm)
        for k, v in jm.items():
            close(m[k], v, TRAIN_TOL, 'step {} metric {}'.format(t, k))
    got = state_dict_to_jax(state.model)
    want = jax_arrays(jst)
    assert any(k.startswith('batch_stats/features_stack/') for k in want)
    for k, v in want.items():
        close(got[k], v, TRAIN_TOL, k)


@pytest.mark.parametrize('features', [None, 'resnet18:8'],
                         ids=['conv', 'resnet'])
def test_transfer_pretrained_matches_jax(tmp_path, features):
    """Mirror of tests/test_transfer_repr.py: the donor's stacks copied and
    frozen; one train step leaves them bit-equal and moves the encoder."""
    jcfg = graft._flagship_cfg(tiny=True)
    if features:
        jcfg = dataclasses.replace(jcfg, features=features)
    d = str(tmp_path / 'donor')
    donor = jjobs.new_job(jcfg, key=jax.random.PRNGKey(1))
    jjobs.save_job(donor, d)
    jjob = jjobs.new_job(jcfg, key=jax.random.PRNGKey(2))
    jtransfer(jjob, features_from=d, upsampler_from=d)

    tjob = tjobs.new_job(port_cfg(jcfg), device='cpu', seed=3)
    before = _snapshot(tjob.model)
    transfer_pretrained(tjob, features_from=d, upsampler_from=d)
    after = _snapshot(tjob.model)
    donor_arrays = jax_arrays(donor.state)
    assert (tjob.training_parameters['frozen_modules']
            == jjob.training_parameters['frozen_modules']
            == ['features_stack', 'imager'])
    for k, v in after.items():
        if k.startswith(('params/features_stack/', 'params/imager/')):
            assert np.array_equal(v, donor_arrays[k]), k
        else:
            assert np.array_equal(v, before[k]), k
    assert not all(np.array_equal(after[k], before[k]) for k in after
                   if k.startswith('params/features_stack/'))

    step = make_train_step(tjob.model, tjob.opt_cfg,
                           frozen_modules=tuple(
                               tjob.training_parameters['frozen_modules']))
    x = _x(8, seed=4, hw=8)
    y = np.arange(8, dtype=np.int32) % 4
    step(tjob.state, torch.from_numpy(x), torch.from_numpy(y))
    moved = _snapshot(tjob.model)
    for k in after:
        if k.startswith(('params/features_stack/', 'params/imager/')):
            assert np.array_equal(moved[k], after[k]), k
    assert any(not np.array_equal(moved[k], after[k])
               for k in after if k.startswith('params/encoder/'))


def test_train_cli_pretrained_features(tmp_path, capsys):
    """``--pretrained-features`` copies a JAX-written job's trunk into the
    new job, which records it frozen and keeps it through training."""
    jcfg = _resnet_cfg()
    d = str(tmp_path / 'donor')
    jjobs.save_job(jjobs.new_job(jcfg, key=jax.random.PRNGKey(1)), d)
    jobs = str(tmp_path / 'jobs')
    argv = ['--dataset', 'cifar10', '--type', 'cvae',
            '--features', 'resnet18:8', '--encoder', '32', '--decoder',
            '36', '--classifier', '16', '-K', '16', '--gamma', '100',
            '--epochs', '1', '--batch-size', '16', '--test-batch-size',
            '32', '--dataset-size', '32', '--latent-sampling', '1',
            '--test-latent-sampling', '2', '--no-final-ood',
            '--job-dir', jobs, '--job-number', '5', '--device', 'cpu',
            '--pretrained-features', d]
    assert train_main(argv + ['--where']) == 0
    where = capsys.readouterr().out.strip().splitlines()[-1]
    assert train_main(argv) == 0
    job = tjobs.load_job(where, device='cpu')
    assert job.training_parameters['frozen_modules'] == ['features_stack']
    assert job.training_parameters['pretrained_features'] == d
    donor = jax_arrays(jjobs.load_job(d).state)
    got = state_dict_to_jax(job.model)
    trunk = [k for k in got if k.startswith('params/features_stack/')]
    assert trunk and all(np.array_equal(got[k], donor[k]) for k in trunk)


def test_tv_densenet_too_small_input_error():
    with pytest.raises(ValueError, match='too small'):
        tresnet.DenseNetFeatures('densenet121', input_hw=(16, 16)).output_shape
    cfg = port_cfg(_resnet_cfg('densenet-tiny:4'))
    with pytest.raises(ValueError, match='too small'):
        CVNet(dataclasses.replace(cfg, features='densenet121'))


@pytest.mark.parametrize('arch, count', [('resnet18', 11_176_512),
                                         ('resnet50', 23_508_032)])
def test_full_width_parameter_count(arch, count):
    """torchvision's trunks without their classifier."""
    m = tresnet.ResNetFeatures(arch)
    assert sum(p.numel() for p in m.parameters()) == count
    assert m.output_shape == (512 * tresnet.RESNET_EXPANSION[arch], 1, 1)


@pytest.mark.parametrize('train', [False, True], ids=['per_class', 'train'])
def test_resnet_cvae_bf16_gate(train, monkeypatch):
    """err(port bf16, jax f32) <= 2 err(jax bf16, jax f32) + 2.5e-4 per
    loss, measure and the logits (``tests/test_torch_bf16.py``).  In
    training it fails (cross_y 6.5e-2 against JAX's 3.0e-2) where
    BatchNorm normalises in bfloat16 instead of float32 as flax does."""
    cfg32 = _resnet_cfg()
    cfg16 = dataclasses.replace(cfg32, compute_dtype='bfloat16')
    opt = jopt.OptimizerConfig(lr=1e-3)
    j32, j16 = (jjobs.new_job(c, opt, key=jax.random.PRNGKey(0))
                for c in (cfg32, cfg16))
    x = _x(N, seed=3, hw=8)
    y = np.arange(N, dtype=np.int32) % 4 if train else None
    L = 1 if train else cfg32.test_latent_sampling
    eps = make_eps((L + 1, N, cfg32.latent_dim))
    inject_jax_eps(monkeypatch, eps)
    kw = dict(train=train, with_beta=train, return_bn_updates=train)
    outs = [jev.evaluate(j.model, j.state.variables, jnp.asarray(x),
                         None if y is None else jnp.asarray(y),
                         rng=jax.random.PRNGKey(0),
                         sigma_state=j.state.sigma_state, **kw)
            for j in (j32, j16)]
    got = tev.evaluate(port_model(cfg16, j16.state), torch.from_numpy(x),
                       None if y is None else torch.from_numpy(y),
                       sigma_state=port_sigma_state(j16.state),
                       eps=torch.from_numpy(eps), **kw)
    if train:
        outs, got = [o[0] for o in outs], got[0]
    assert got.x_reco.dtype == torch.bfloat16
    for k, v in outs[0].losses.items():
        gate(got.losses[k], outs[1].losses[k], v, 'loss ' + k)
    for k, v in outs[0].measures.items():
        gate(got.measures[k], outs[1].measures[k], v, 'measure ' + k)
    gate(got.logits, outs[1].logits, outs[0].logits, 'logits')
