"""The named training configurations of ``configs/default.ini`` as the
port's tests take them: each section through both packages'
``utils/parameters`` (``--config <section>``), and a twin of each with
the section's own layer structure at widths the CPU trains in seconds.
Imports the JAX package; the card's phase (``chip_smoke.py --configs``)
keeps its own list."""

import configparser
import dataclasses
import os
import re

from joint_vae_tpu.models import conv as jconv
from joint_vae_tpu.utils import parameters as jparams

from joint_vae_tpu_torch.utils import parameters as tparams

CONFIG_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'default.ini')


def all_sections() -> list:
    """[DEFAULT] and every section of the file, in its order."""
    cp = configparser.ConfigParser()
    cp.read(CONFIG_FILE)
    return ['DEFAULT'] + cp.sections()


# the sections the port runs on the card, in the order a run meets their
# surfaces; [imagenet] (vgg19 on 3x224x224 with a 4096-wide decoder) is
# refused by both packages alike (REFUSED)
SECTIONS = ('DEFAULT', 'mnist-dense', 'mnist-vae', 'mnist-vib', 'cifar10',
            'tilted', 'mnist-vgg', 'fashion', 'fashion-vgg16', 'svhn',
            'cifar10-vgg', 'autoencoder', 'vgg-baseline')
REFUSED = {'imagenet': 'Could not go from 4096 to *, 7 7'}


def section_args(params, section: str):
    return params.get_args(['--config', section, '--config-file',
                            CONFIG_FILE])


def jax_config(section: str):
    """The JAX package's model config, optimizer config and args."""
    args = section_args(jparams, section)
    return (jparams.model_config_from_args(args),
            jparams.optimizer_config_from_args(args), args)


def port_config(section: str):
    """The port's model config, optimizer config and args."""
    args = section_args(tparams, section)
    return (tparams.model_config_from_args(args),
            tparams.optimizer_config_from_args(args), args)


def _cut_stack(spec: str, factor: int, upsampler: bool) -> str:
    """A conv stack spec with every layer's channel count divided by
    ``factor`` (at least 4), its kernels, strides, pads and pools kept,
    and an upsampler's last layer (the image's channels) as it is."""
    spec = jconv.FEATURES_ARCHS.get(spec, jconv.UPSAMPLER_ARCHS.get(spec,
                                                                    spec))
    head, body = spec.split(']', 1)
    items = body.split('-')
    for i, item in enumerate(items):
        m = re.match(r'^(\d+)(.*)$', item)
        if m and not (upsampler and i == len(items) - 1):
            item = str(max(4, int(m.group(1)) // factor)) + m.group(2)
            items[i] = item
    return head + ']' + '-'.join(items)


# the twins' cuts: conv channel widths by 8 (vgg's 64-512 to 8-64,
# conv32's and deconv32's 32-200 to 4-25, the sub-pixel upsampler's
# 512-64 to 64-8), test L of the conv sections to 4 (their decoder runs
# L + 1 times a batch); MLP widths, K, C, the priors, sigma, activations,
# BatchNorm and every kernel, stride, pad and pool as the section has them
CONV_CUT, CONV_TEST_L = 8, 4


def twin_config(jcfg):
    """The section's twin: its JAX config with conv widths and test L
    cut (an MLP section unchanged)."""
    if jcfg.features is None and jcfg.upsampler is None:
        return jcfg
    kw = dict(test_latent_sampling=min(CONV_TEST_L, jcfg.test_latent_sampling))
    for key in ('features', 'upsampler'):
        spec = getattr(jcfg, key)
        if spec is not None:
            kw[key] = _cut_stack(spec, CONV_CUT, key == 'upsampler')
    return dataclasses.replace(jcfg, **kw)
