"""The port's model against the JAX package: conv-DSL plans for every named
arch, conv stacks with bridged weights, the flagship's configuration and
routes, and the weight bridge's bit-exact round trip.  ``evaluate`` is in
test_torch_evaluate.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from joint_vae_tpu.models import conv as jconv
from joint_vae_tpu.save_load.checkpoint import flatten_pytree
from joint_vae_tpu.save_load.jobs import new_job as jnew_job

from joint_vae_tpu_torch.models import conv as tconv
from joint_vae_tpu_torch.models.cvnet import flagship_config
from joint_vae_tpu_torch.save_load.from_jax import (jax_to_state_dict,
                                                    state_dict_to_jax)

from torch_port_util import close, jax_arrays, port_cfg, port_model


def _plans_equal(a, b):
    assert a[0] == b[0]
    assert [dataclasses.asdict(p) for p in a[1]] == \
        [dataclasses.asdict(p) for p in b[1]]
    assert tuple(a[2]) == tuple(b[2])


@pytest.mark.parametrize('arch', sorted(jconv.FEATURES_ARCHS))
def test_features_plans_match(arch):
    assert tconv.FEATURES_ARCHS[arch] == jconv.FEATURES_ARCHS[arch]
    for bn in (False, True):
        _plans_equal(tconv.conv_stack_plan((3, 32, 32), arch, 'input',
                                           batch_norm=bn),
                     jconv.conv_stack_plan((3, 32, 32), arch, 'input',
                                           batch_norm=bn))


@pytest.mark.parametrize('arch', sorted(jconv.UPSAMPLER_ARCHS))
def test_upsampler_plans_match(arch):
    assert tconv.UPSAMPLER_ARCHS[arch] == jconv.UPSAMPLER_ARCHS[arch]
    for want in ((32, 32), (16, 16)):
        try:
            hw = jconv.find_input_shape(arch, want)
        except ValueError:
            with pytest.raises(ValueError):
                tconv.find_input_shape(arch, want)
            continue
        assert tconv.find_input_shape(arch, want) == hw
        for dist in ('gaussian', 'categorical'):
            kw = dict(where='output', activation='relu',
                      output_activation='sigmoid', output_distribution=dist)
            _plans_equal(tconv.conv_stack_plan((64, *hw), arch, **kw),
                         jconv.conv_stack_plan((64, *hw), arch, **kw))


STACKS = [
    # (input shape, DSL, where, batch_norm, output distribution)
    ((4, 3, 3), '[x3+1]8x2+0-8:2++1-!3x3+1', 'output', False, 'gaussian'),
    ((6, 1, 1), '[x5+2]8x4+0-8-8:2++1-!3x5+2', 'output', False, 'gaussian'),
    ((4, 2, 2), '[!x3+1-U:2]U-!8-U-!3', 'output', True, 'gaussian'),
    ((6, 1, 1), '[x3+1]8x4+0-4:2++1-!1x3+1', 'output', False, 'categorical'),
    ((3, 8, 8), '[x3+1-Mx2]8-M-8:2-6x1+0-Ax2', 'input', True, 'gaussian'),
]


@pytest.mark.parametrize('spec', STACKS, ids=[s[1] for s in STACKS])
def test_conv_stack_matches_jax(spec):
    in_shape, dsl, where, bn, dist = spec
    kw = dict(where=where, batch_norm=bn, activation='relu')
    if where == 'output':
        kw.update(output_activation='sigmoid', output_distribution=dist)
    _, jplans, _ = jconv.conv_stack_plan(in_shape, dsl, **kw)
    _, tplans, _ = tconv.conv_stack_plan(in_shape, dsl, **kw)
    jstack = jconv.ConvStack(input_shape=in_shape, plans=jplans, where=where,
                             output_distribution=dist)
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 3) + in_shape).astype(np.float32)
    variables = jstack.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
                              .astype(np.float32)), variables)
    want = jstack.apply(variables, jnp.asarray(x), False)
    tstack = tconv.ConvStack(in_shape, tplans, output_distribution=dist,
                             where=where)
    tstack.load_state_dict(jax_to_state_dict(tstack, flatten_pytree(variables)))
    got = tstack(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    close(got, want, 2e-5)


def test_flagship_config_matches():
    for tiny in (True, False):
        assert flagship_config(tiny).architecture == \
            graft._flagship_cfg(tiny=tiny).architecture
        assert port_cfg(graft._flagship_cfg(tiny=tiny)) == flagship_config(tiny)


def test_bridge_round_trip_is_bit_exact():
    from test_torch_evaluate import EVAL_CFGS
    jcfg = EVAL_CFGS['cvae_bn_hsv_learned_sigma']()
    job = jnew_job(jcfg, key=jax.random.PRNGKey(5))
    arrays = jax_arrays(job.state)
    model = port_model(jcfg, job.state)
    back = state_dict_to_jax(model)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_flagship_full_width_builds():
    from joint_vae_tpu_torch.models.cvnet import CVNet
    model = CVNet(flagship_config())
    assert sum(p.numel() for p in model.parameters()) == 3849523
    routes = {n: m.route for s in (model.features_stack, model.imager)
              for n, m in s.conv_layers()}
    assert [n for n, r in routes.items() if r == 'same_grid'] == \
        ['conv_0', 'conv_2', 'deconv_1', 'deconv_3', 'deconv_5', 'conv_6']
    assert [m.route for _, m in model.imager.conv_layers()] == \
        ['matmul', 'same_grid', 'subpixel', 'same_grid', 'subpixel',
         'same_grid', 'same_grid']
    assert routes['conv_4'] == 'conv'
    assert 'transpose' not in routes.values()
