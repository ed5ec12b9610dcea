"""The benchmark's operation and byte counts (``counts/flops.py``),
read from the configuration files, against the bounds PERF.md's kernel
table gives for the flagship ("Bound ms" of the conv and the combine):

- 6.88 ms a serve batch of 512 at L=16 and 1.05 / 1.01 ms a train step's
  forward / data gradient at 1024 count the conv as launched, where a
  stride-2 deconv runs as a sub-pixel conv of 3x3 taps to 4 co phases on
  its input grid: 72 k-products per input pixel where the deconv itself
  does 50 (k=5).  The benchmark counts the deconv's own work, so this
  test adds that padding back to reproduce the table within 1%;
- 0.0047 ms for the combine at (L, N, C, K) = (16, 512, 100, 128): 3 L C
  N K operations at the CUDA cores' 67 TFLOP/s.
"""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

from counts import flops   # noqa: E402
from harness import peaks  # noqa: E402


def load(name):
    with open(os.path.join(BENCH, 'configs', name + '.json')) as f:
        return json.load(f)


def subpixel_taps(k: int, p: int, s: int) -> int:
    """Taps per axis of the sub-pixel conv of a stride-s deconv: the
    distinct input offsets its k taps land on over the s output phases."""
    off = k - 1 - p
    return len({(r + t - off) // s for r in range(s) for t in range(k)
                if (r + t - off) % s == 0})


def launched_bound_ms(cfg, n, L, grad=False):
    """The conv's least time with each sub-pixel site counted as launched."""
    total = 0.0
    for site in cfg['conv_sites']:
        if grad and not site['dx']:
            continue
        sh = flops.site_shapes(cfg, site, n, L)
        fl, by = flops.site_work(sh)
        if sh['route'] == 'subpixel':
            ly = cfg[site['stack'] + '_layers'] if site['stack'] == 'imager' \
                else cfg['features_layers']
            ly = ly[site['layer']]
            t = subpixel_taps(ly['k'], ly['pad'], ly['stride'])
            fl = fl * (t * t * ly['stride'] ** 2) / ly['k'] ** 2
            by += 4 * (t * t * ly['stride'] ** 2 - ly['k'] ** 2) \
                * sh['ci'] * sh['co']
        total += max(fl / peaks.FLOAT32_FLOPS, by / peaks.HBM_BYTES_PER_S)
    return total * 1e3


@pytest.mark.parametrize('n, L, grad, want', [
    (512, 16, False, 6.88), (1024, 1, False, 1.05), (1024, 1, True, 1.01)])
def test_conv_bounds_as_launched(n, L, grad, want):
    got = launched_bound_ms(load('cifar100'), n, L, grad)
    assert abs(got - want) / want < 0.01, got


def test_subpixel_padding_is_the_only_difference():
    cfg = load('cifar100')
    true = flops.conv_least_s(cfg, 512, 16, peaks.FLOAT32_FLOPS,
                              peaks.HBM_BYTES_PER_S) * 1e3
    # two stride-2 sites at 8x8 -> 16x16 (64 -> 64) and 16x16 -> 32x32
    # (32 -> 32) on 8,192 images: 36 k-products per input pixel launched
    # (3x3 taps to 4 phases) where the deconv does 25
    extra = sum(2 * 8192 * h * h * (36 - 25) * c * c
                for h, c in ((8, 64), (16, 32)))
    assert abs(true + extra / peaks.FLOAT32_FLOPS * 1e3 - 6.88) / 6.88 < 0.01
    assert true < 6.88


def test_combine_bound():
    got = flops.combine_least_s(16, 512, 100, 128,
                                peaks.CUDA_CORE_FLOAT32_FLOPS,
                                peaks.HBM_BYTES_PER_S) * 1e3
    assert abs(got - 0.0047) / 0.0047 < 0.01, got


@pytest.mark.parametrize('name', ['cifar100', 'cifar10-vgg'])
def test_files_hold_their_counts(name):
    cfg = load(name)
    assert flops.param_count(cfg) == cfg['params']
    assert flops.train_flops_per_image(cfg) == cfg['flops']['train_per_image']
    assert flops.score_flops_per_image(cfg, cfg['test_latent_sampling']) \
        == cfg['flops']['score_per_image']


@pytest.mark.parametrize('name, serve, fwd, dx', [
    ('cifar100', 8, 8, 7), ('cifar10-vgg', 25, 22, 21)])
def test_launches_per_batch_and_step(name, serve, fwd, dx):
    """The conv kernel's launches a serve batch at 512 and the test L, and
    a step's forward and data gradient at the train batch: PERF.md's
    "per batch / per step" (a 65,536-image batch launches three of
    deconv32's sites twice within the kernel's int32 shapes)."""
    cfg = load(name)
    L, B = cfg['test_latent_sampling'], cfg['batch_size']
    assert flops.conv_launches(cfg, 512, L) == serve
    assert flops.conv_launches(cfg, B, 1) == fwd
    assert flops.conv_launches(cfg, B, 1, grad=True) == dx
