"""The named training configurations (``configs/default.ini``) through the
port's ``utils/parameters`` against the JAX package's, section by
section: the same model config, field by field, the same optimizer and
training settings, and the same parameter count at full width (the JAX
side through ``jax.eval_shape``, so nothing large is computed; the
port's on the meta device).  A section the JAX package cannot build
([imagenet]) is refused by both packages with the same error.  Then the
12-step trajectories of the MLP sections' and the conv32 sections' twins
(``tests/torch_config_twins.py``; the vgg sections' are in
``test_torch_configs_train.py``, so the heavy cases spread over files),
and var_kl's precision at the sections' largest K."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_vae_tpu.models.cvnet import CVNet as JCVNet

from joint_vae_tpu_torch.models.cvnet import CVNet

from torch_config_cases import (REFUSED, SECTIONS, all_sections, jax_config,
                                port_config)
from torch_config_twins import check_train_steps
from torch_port_util import port_cfg

# the port's parser adds --device; the JAX package's --platform,
# --force-cpu and its --device spelling (dest platform_device)
DEVICE_ARGS = {'device', 'platform', 'force_cpu', 'platform_device'}


def jax_param_count(jcfg) -> int:
    model = JCVNet(jcfg)
    x = jnp.zeros((2,) + tuple(jcfg.input_shape), jnp.float32)
    y = jnp.zeros((2,), jnp.int32) if jcfg.y_is_coded else None
    shapes = jax.eval_shape(lambda: model.init(
        {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)},
        x, y, train=False))
    return sum(int(np.prod(v.shape))
               for v in jax.tree_util.tree_leaves(shapes['params']))


def port_param_count(cfg) -> int:
    with torch.device('meta'):
        model = CVNet(cfg)
    return sum(p.numel() for p in model.parameters())


def test_sections_listed():
    """Every section of the file is run on the card or refused by both."""
    assert set(all_sections()) - {'cifar100', 'wim-default'} == \
        set(SECTIONS) | set(REFUSED)


@pytest.mark.parametrize('section', all_sections())
def test_section_matches_jax(section):
    jcfg, jopt, jargs = jax_config(section)
    cfg, opt, args = port_config(section)
    ja, ta = vars(jargs), vars(args)
    assert set(ja) - DEVICE_ARGS == set(ta) - DEVICE_ARGS
    for k in set(ta) - DEVICE_ARGS:
        assert ta[k] == ja[k], k
    jo, to = dataclasses.asdict(jopt), dataclasses.asdict(opt)
    assert jo.pop('amsgrad') is False
    assert to == jo
    assert cfg.architecture == jcfg.architecture
    want = port_cfg(jcfg)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(want, f.name), f.name
    if section in REFUSED:
        with pytest.raises(Exception) as jerr:
            jax_param_count(jcfg)
        with pytest.raises(Exception) as terr:
            port_param_count(cfg)
        assert str(jerr.value) == str(terr.value) == REFUSED[section]
        return
    assert port_param_count(cfg) == jax_param_count(jcfg)


@pytest.mark.parametrize('section', SECTIONS[:6])
def test_section_train_steps_match_jax(section, monkeypatch):
    check_train_steps(section, monkeypatch)


@pytest.mark.parametrize('all_classes', [False, True])
@pytest.mark.parametrize('K', [512, 1024])
def test_var_kl_precise_at_large_k(K, all_classes):
    """[fashion]'s and [fashion-vgg16]'s K: var_kl = trace - log det + log
    det prior - K, a difference of sums of K terms near 1, is summed in
    float64 and rounded once, so float32 inputs give it within 1e-6 of the
    float64 value (a float32 sum lies ulps of K away: 1.22e-4 each at
    1024, which card and CPU round differently)."""
    from joint_vae_tpu_torch.ops.priors import build_prior_config, prior_kl
    rng = np.random.default_rng(11)
    cfg = build_prior_config(K, 'gaussian', num_priors=10, init_mean=17.0,
                             learned_means=True)
    params = {'mean': torch.from_numpy(17 * rng.standard_normal((10, K))),
              'var_param': torch.ones(10, dtype=torch.float64)}
    mu = torch.from_numpy(rng.standard_normal((4, K)))
    log_var = torch.from_numpy(0.05 * rng.standard_normal((4, K)))
    y = None if all_classes else torch.arange(4) % 10
    got = prior_kl(cfg, {k: v.float() for k, v in params.items()}, mu.float(),
                   log_var.float(), y=y, all_classes=all_classes)['var_kl']
    want = prior_kl(cfg, params, mu, log_var, y=y,
                    all_classes=all_classes)['var_kl']
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
