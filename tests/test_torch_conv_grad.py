"""The port's conv gradients against the JAX package.

``SameGridConvFn`` (the plain version on the CPU) is held against
``jax.vjp`` of ``pallas_conv._same_grid_conv`` (the Pallas kernel in
interpret mode, whose custom vjp is XLA's conv vjp) at 5x5 pads (2, 2),
an asymmetric-pad stride-1 deconv and a packed sub-pixel geometry, dx
and dw within 1e-5; the dx wrapper against its plain version and the
im2col weight gradient against the per-tap sum, chunked or not; and the
launch pattern of a flagship backward: one dx per same-grid site except
the data-reading first conv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import joint_vae_tpu.ops.pallas_conv as pc

import joint_vae_tpu_torch.ops.same_grid_conv as sgc
from joint_vae_tpu_torch.models.conv import ConvLayer, _packed_kernel
from joint_vae_tpu_torch.models.cvnet import CVNet, flagship_config, init_weights
from joint_vae_tpu_torch.ops.same_grid_conv import SameGridConvFn

from torch_kernel_cases import FLAGSHIP_DX_GEOMS, conv_inputs
from torch_port_util import close

GRAD_GEOMS = {
    # (n, h, w, ci, co, th, tw, ph_lo, pw_lo)
    '5x5_pad2': (2, 8, 8, 3, 8, 5, 5, 2, 2),
    # a stride-1 deconv k=4, p=2, op=1: pads (k-1-p, k-1-p+op) = (1, 2)
    'deconv_asym': (2, 6, 7, 5, 6, 4, 4, 1, 1),
    'asym_0_2': (2, 8, 8, 4, 4, 3, 3, 0, 2),
    'subpixel_packed': (2, 16, 16, 32, 128, 3, 3, 1, 1),
}


def _grads_port(x, k, g, ph, pw):
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    y = SameGridConvFn.apply(xt, kt, ph, pw)
    dx, dk = torch.autograd.grad(y, (xt, kt), torch.from_numpy(g))
    return y, dx, dk


@pytest.mark.parametrize('name', sorted(GRAD_GEOMS))
def test_same_grid_fn_grads_match_jax_vjp(name):
    geom = GRAD_GEOMS[name]
    n, h, w, ci, co, th, tw, ph, pw = geom
    x, k = conv_inputs(geom, seed=3)
    # output gradients of a loss's scale: dw sums n*h*w products in float32
    g = 0.05 * np.random.default_rng(4).standard_normal((n, h, w, co)).astype(
        np.float32)
    y, dx, dk = _grads_port(x, k, g, ph, pw)
    want_y, vjp = jax.vjp(lambda x_, k_: pc._same_grid_conv(x_, k_, ph, pw, 4096),
                          jnp.asarray(x), jnp.asarray(k))
    want_dx, want_dk = vjp(jnp.asarray(g))
    close(y, want_y, 1e-5, 'y')
    close(dx, want_dx, 1e-5, 'dx')
    close(dk, want_dk, 1e-5, 'dw')


@pytest.mark.parametrize('chunk_bytes', [sgc.IM2COL_BYTES, 1])
@pytest.mark.parametrize('name', sorted(GRAD_GEOMS))
def test_dx_wrapper_and_weight_grad_match_plain(name, chunk_bytes,
                                                 monkeypatch):
    n, h, w, ci, co, th, tw, ph, pw = GRAD_GEOMS[name]
    x, k = (torch.from_numpy(a) for a in conv_inputs(GRAD_GEOMS[name], seed=5))
    g = 0.05 * torch.randn((n, h, w, co),
                           generator=torch.Generator().manual_seed(6))
    before = sgc.same_grid_conv_dx.launches
    dx = sgc.same_grid_conv_dx(g, k, ph, pw)
    assert sgc.same_grid_conv_dx.launches == before      # the CPU launches nothing
    close(dx, sgc.same_grid_conv_dx_plain(g, k, ph, pw), 0)
    # the im2col product against the per-tap sum of shifted inputs
    xp = torch.nn.functional.pad(x, (0, 0, pw, tw - 1 - pw, ph, th - 1 - ph))
    taps = torch.stack([torch.stack([
        torch.einsum('nhwc,nhwd->cd', xp[:, a:a + h, b:b + w], g)
        for b in range(tw)]) for a in range(th)])
    monkeypatch.setattr(sgc, 'IM2COL_BYTES', chunk_bytes)   # 1: image by image
    close(sgc.same_grid_conv_dw(x, g, th, tw, ph, pw), taps, 1e-5)


def test_flagship_dx_geoms_are_the_model_sites():
    """The card tests' dx geometries are the flagship's same-grid sites
    (their launched kernels: packed at the sub-pixel ones) whose input
    needs a gradient."""
    model = CVNet(flagship_config())
    got = {}
    for stack_name in ('features_stack', 'imager'):
        stack = getattr(model, stack_name)
        c, h, w = stack.input_shape
        for i, pl in enumerate(stack.plans):
            name = '{}_{}'.format(pl.ltype, i)
            mod = getattr(stack, name, None)
            if isinstance(mod, ConvLayer) and mod.route in ('same_grid',
                                                            'subpixel'):
                kd = (mod.weight if mod.route == 'same_grid' else
                      _packed_kernel(mod.weight, mod.tap, mod.tap))
                th, tw, ci, co = kd.shape
                got['{}.{}'.format(stack_name, name)] = (
                    h, w, ci, co, th, tw, mod.pads[0], mod.pads[0])
            c, h, w = pl.out_shape
    del got['features_stack.conv_0']              # reads the data: no dx
    assert got == {k: g[1:] for k, g in FLAGSHIP_DX_GEOMS.items()}


def test_tiny_flagship_backward_launch_pattern(monkeypatch):
    """A backward through the model computes one dx per same-grid site
    whose input needs a gradient — not the first conv's, which reads the
    data — and a weight gradient at every site."""
    calls = {'fwd': 0, 'dx': 0, 'dw': 0}
    for name, key in (('same_grid_conv', 'fwd'), ('same_grid_conv_dx', 'dx'),
                      ('same_grid_conv_dw', 'dw')):
        fn = getattr(sgc, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)
        counted.launches = 0
        monkeypatch.setattr(sgc, name, counted)
    model = init_weights(CVNet(flagship_config(tiny=True)), 0)
    sites = [m for m in model.modules() if isinstance(m, ConvLayer)
             and m.route in ('same_grid', 'subpixel')]
    x = torch.rand((3,) + model.cfg.input_shape,
                   generator=torch.Generator().manual_seed(0))
    z = model.encode(model.features(x))[0]
    loss = model.decode(z).square().mean()
    assert calls['fwd'] == len(sites)
    loss.backward()
    assert calls == {'fwd': len(sites), 'dx': len(sites) - 1,
                     'dw': len(sites)}
    for m in sites:
        assert m.weight.grad is not None and torch.count_nonzero(m.weight.grad)
