"""The port's sub-pixel and matmul deconv routes against the JAX package's
lowerings.

A stride-s deconv whose packed conv keeps the grid runs as the same-grid
conv to s^2 phase-packed channels plus depth_to_space ('subpixel', JAX:
``packed_conv(f_in=1, f_out=s)`` + ``_unpack_to``); a deconv on a 1x1
input is one matmul with the flipped kernel ('matmul', JAX: the einsum
with ``_flipped_1x1_kernel``).  The tap tables and packed kernels must
equal JAX's exactly; the layer outputs are held to the JAX lowering (the
Pallas same-grid kernel in interpret mode included) and to
``F.conv_transpose2d`` at 1e-5 (float32 sums of at most 5*5*8 products in
another order), on numpy-seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from joint_vae_tpu.models import conv as jconv

from joint_vae_tpu_torch.models import conv as tconv
from joint_vae_tpu_torch.ops.same_grid_conv import same_grid_conv

from torch_port_util import close

TOL = 1e-5

# (k, p, s, op, h, route): stride-s deconvs of an h x h input
DECONVS = [
    (5, 2, 2, 1, 8, 'subpixel'),     # the flagship's deconv_2 / deconv_4
    (3, 1, 2, 1, 4, 'subpixel'),
    (4, 1, 2, 0, 5, 'subpixel'),
    (5, 2, 2, 0, 8, 'subpixel'),     # odd output (15): sliced after unpacking
    (5, 2, 3, 2, 4, 'subpixel'),     # stride 3, pads (0, 1)
    (2, 0, 2, 0, 3, 'subpixel'),     # 1x1 packed taps
    (3, 0, 2, 0, 4, 'transpose'),    # ceil(9 / 2) = 5 != 4: not same-grid
    (7, 0, 2, 0, 4, 'transpose'),    # ceil(13 / 2) = 7 != 4
]
IDS = ['k{}p{}s{}op{}h{}'.format(*d[:5]) for d in DECONVS]


def _out(k, p, s, op, h):
    return (h - 1) * s - 2 * p + k + op


def _plan(k, p, s, op, co, oh):
    return tconv.LayerPlan(ltype='deconv', out_channels=co, kernel_size=k,
                           padding=p, stride=s, output_padding=op,
                           out_shape=(co, oh, oh))


def _jax_same_grid(k, p, s, op, h):
    """JAX's own test: packed stride 1 and pads summing to the tap extent."""
    g, dmin, tap = jconv._packed_geometry(k, k - 1 - p, 1, s, 1, s)
    p_h = -(-_out(k, p, s, op, h) // s)
    lo, hi = -dmin, g * (p_h - 1) + dmin + tap.shape[0] - 1 - (h - 1)
    return g == 1 and lo >= 0 and hi >= 0 and lo + hi == tap.shape[0] - 1


def _layer(pl, ci, h, kern, bias):
    layer = tconv.ConvLayer(pl, ci, h, h)
    layer.load_state_dict({'weight': layer.from_hwio(torch.from_numpy(kern)),
                           'bias': torch.from_numpy(bias)})
    return layer


def _inputs(n, h, ci, k, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, h, ci)).astype(np.float32)
    kern = (rng.standard_normal((k, k, ci, co)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return x, kern, bias


def _torch_deconv(x, kern, bias, k, p, s, op):
    """F.conv_transpose2d of the correlation-oriented HWIO kernel."""
    wt = torch.flip(torch.from_numpy(kern), (0, 1)).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), wt,
                           torch.from_numpy(bias), stride=s, padding=p,
                           output_padding=op)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize('geom', DECONVS, ids=IDS)
def test_packed_geometry_and_kernel_match_jax(geom):
    k, p, s, op, h, _ = geom
    for args in ((k, k - 1 - p, 1, s, 1, s), (k, p, 1, 1, 1, 2)):
        g, dmin, tap = tconv._packed_geometry(*args)
        jg, jdmin, jtap = jconv._packed_geometry(*args)
        assert (g, dmin) == (jg, jdmin)
        np.testing.assert_array_equal(tap, jtap)
        kern = np.random.default_rng(k).standard_normal(
            (k, k, 3, 4)).astype(np.float32)
        got = tconv._packed_kernel(torch.from_numpy(kern), tap, tap)
        want = jconv._packed_kernel(jnp.asarray(kern), jtap, jtap)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('geom', DECONVS, ids=IDS)
def test_deconv_route_follows_jax_same_grid_rule(geom):
    k, p, s, op, h, route = geom
    pl = _plan(k, p, s, op, 4, _out(k, p, s, op, h))
    got, pads = tconv.conv_route(pl, h, h)
    assert got == route
    assert (got == 'subpixel') == _jax_same_grid(k, p, s, op, h)
    if got == 'subpixel':
        _, dmin, tap = jconv._packed_geometry(k, k - 1 - p, 1, s, 1, s)
        assert pads == (-dmin, dmin + tap.shape[0] - 1)


@pytest.mark.parametrize('geom', DECONVS, ids=IDS)
def test_strided_deconv_matches_jax_and_torch(geom):
    k, p, s, op, h, route = geom
    n, ci, co = 3, 8, 5
    oh = _out(k, p, s, op, h)
    x, kern, bias = _inputs(n, h, ci, k, co, seed=k * 10 + h)
    layer = _layer(_plan(k, p, s, op, co, oh), ci, h, kern, bias)
    assert layer.route == route
    launches = same_grid_conv.launches
    got = layer(torch.from_numpy(x))
    assert same_grid_conv.launches == launches          # plain version on CPU
    assert tuple(got.shape) == (n, oh, oh, co)
    y = jconv.packed_conv(jnp.asarray(x), jnp.asarray(kern), k=k,
                          off=k - 1 - p, num=1, den=s, f_in=1, f_out=s,
                          h_out=oh, w_out=oh)
    want = jconv._unpack_to(y, s, oh, oh) + jnp.asarray(bias)
    close(got, want, TOL, 'vs JAX packed_conv + _unpack_to')
    close(got, _torch_deconv(x, kern, bias, k, p, s, op), TOL,
          'vs F.conv_transpose2d')


def test_subpixel_matches_jax_pallas_interpret(monkeypatch):
    """The flagship's sub-pixel geometry with the JAX package's same-grid
    Pallas kernel switched on (interpret mode on the CPU)."""
    import joint_vae_tpu.ops.pallas_conv as pc
    k, p, s, op, h = 5, 2, 2, 1, 8
    n, ci, co = 8, 8, 4                       # n*h*w = 512: the kernel runs
    oh = _out(k, p, s, op, h)
    x, kern, bias = _inputs(n, h, ci, k, co, seed=5)
    monkeypatch.setenv('JVT_PALLAS_CONV', '1')
    calls = []
    real = pc._same_grid_conv
    monkeypatch.setattr(pc, '_same_grid_conv',
                        lambda *a: calls.append(a[2:4]) or real(*a))
    y = jconv.packed_conv(jnp.asarray(x), jnp.asarray(kern), k=k,
                          off=k - 1 - p, num=1, den=s, f_in=1, f_out=s,
                          h_out=oh, w_out=oh)
    assert calls == [(1, 1)]
    want = jconv._unpack_to(y, s, oh, oh) + jnp.asarray(bias)
    layer = _layer(_plan(k, p, s, op, co, oh), ci, h, kern, bias)
    close(layer(torch.from_numpy(x)), want, TOL, 'vs Pallas interpret')


# (k, p, s, op): deconvs of a 1x1 input (the latent expansion)
EXPANSIONS = [(8, 0, 1, 0), (4, 0, 1, 0), (4, 1, 2, 1), (3, 0, 2, 0)]


@pytest.mark.parametrize('geom', EXPANSIONS,
                         ids=['k{}p{}s{}op{}'.format(*g) for g in EXPANSIONS])
def test_matmul_expansion_matches_jax_and_torch(geom):
    k, p, s, op = geom
    n, ci, co = 4, 16, 6
    oh = _out(k, p, s, op, 1)
    x, kern, bias = _inputs(n, 1, ci, k, co, seed=k)
    pl = _plan(k, p, s, op, co, oh)
    assert tconv.conv_route(pl, 1, 1)[0] == 'matmul'
    kf = tconv._flipped_1x1_kernel(torch.from_numpy(kern), k, p, oh)
    jkf = jconv._flipped_1x1_kernel(jnp.asarray(kern), k, p, oh)
    np.testing.assert_array_equal(kf.numpy(), np.asarray(jkf))
    got = _layer(pl, ci, 1, kern, bias)(torch.from_numpy(x))
    assert tuple(got.shape) == (n, oh, oh, co)
    want = jnp.einsum('nc,hwcd->nhwd', jnp.asarray(x)[:, 0, 0, :], jkf) \
        + jnp.asarray(bias)
    close(got, want, TOL, 'vs JAX einsum')
    close(got, _torch_deconv(x, kern, bias, k, p, s, op), TOL,
          'vs F.conv_transpose2d')


@pytest.mark.parametrize('f', [1, 2, 3])
def test_depth_to_space_matches_jax(f):
    x = np.random.default_rng(f).standard_normal(
        (2, 3, 4, f * f * 5)).astype(np.float32)
    got = tconv.depth_to_space(torch.from_numpy(x), f)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jconv.depth_to_space(
                                      jnp.asarray(x), f)))


@pytest.mark.parametrize('route', ['subpixel', 'matmul'])
def test_hwio_routes_round_trip_exactly(route):
    pl = (_plan(5, 2, 2, 1, 4, 16) if route == 'subpixel'
          else _plan(8, 0, 1, 0, 4, 8))
    h = 8 if route == 'subpixel' else 1
    layer = tconv.ConvLayer(pl, 3, h, h)
    assert layer.route == route
    k = torch.from_numpy(np.random.default_rng(0).standard_normal(
        tuple(layer.weight.shape)).astype(np.float32))
    assert torch.equal(layer.to_hwio(layer.from_hwio(k)), k)
    assert 'tap' not in layer.state_dict()
