"""The ResNet and DenseNet trunks' conv backward
(``models/resnet.py::TrunkConv`` through ``models/conv.py::
DeterministicConvFn`` with the im2col weight gradient,
``ops/same_grid_conv.py::im2col_dw``) against float64 autograd of
``F.conv2d`` and against ``jax.vjp`` of the JAX trunk's ``nn.Conv``:

- dx and dw at every trunk geometry (7x7 s2 p3, the stem; 3x3 s1 and s2
  p1; 1x1 s1 and s2 p0), each element within 1e-4 (|want| + rms(want));
  in float64 the Function against float64 autograd within 1e-12;
- a batch whose im2col copy spans two chunks (``IM2COL_BYTES`` made
  small) against the same batch in one chunk and float64;
- the same-grid conv's dw, now the stride-1 case of ``im2col_dw``,
  bit for bit the earlier same-grid product in float32, bfloat16 and
  float64, at symmetric and asymmetric pads;
- ``TrunkConv`` routing: float32 and float64 through the Function, the
  im2col weight gradient on a CUDA tensor and ``F.conv2d``'s on the CPU
  (bit for bit ``F.conv2d``'s autograd there); bfloat16 through
  ``F.conv2d``;
- on a card (``cuda`` marker; skips without one): the route there, and a
  resnet18 ResNet flagship's float32 train step repeated from one state,
  batch and noise, bit for bit.  JAX is imported where it is used, so
  that these run where it is not installed (``python -m pytest
  tests/test_torch_trunk_conv.py --noconftest -m cuda``).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from joint_vae_tpu_torch.models import conv as tconv
from joint_vae_tpu_torch.models.resnet import TrunkConv
from joint_vae_tpu_torch.ops import same_grid_conv as sgc

# (kernel, stride, pad, cin, cout, input side): the trunks' convs
# (joint_vae_tpu/models/resnet.py: the stem at :263, the blocks' 3x3 and
# 1x1 projections at :78-88 and :111-121), at narrow widths
GEOMETRIES = {
    'stem_7x7_s2_p3': (7, 2, 3, 3, 8, 12),
    '3x3_s1_p1': (3, 1, 1, 8, 8, 6),
    '3x3_s2_p1': (3, 2, 1, 8, 16, 7),
    '1x1_s1_p0': (1, 1, 0, 16, 12, 5),
    '1x1_s2_p0': (1, 2, 0, 8, 16, 6),
}
N = 5
TOL = 1e-4


def _inputs(k, cin, cout, side, seed=0, n=N):
    """x (n, side, side, cin) NHWC, w (cout, cin, k, k) OIHW and an output
    gradient for F.conv2d's output grid, float64 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, side, side, cin))
    w = rng.standard_normal((cout, cin, k, k)) / np.sqrt(cin * k * k)
    return x, w, rng


def _out_side(side, k, s, p):
    return (side + 2 * p - k) // s + 1


def _ratio(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    return float(np.max(np.abs(got - want) / (np.abs(want) + rms + 1e-300)))


def _function_grads(x, w, g, s, p, dtype):
    """dx (NHWC) and dw (OIHW) through the Function with the im2col dw."""
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    wt = torch.tensor(w, dtype=dtype, requires_grad=True)
    y = tconv.DeterministicConvFn.apply(xt.permute(0, 3, 1, 2), wt, s, p,
                                        True)
    dx, dw = torch.autograd.grad(y, (xt, wt),
                                 torch.tensor(g, dtype=dtype))
    return dx, dw


def _autograd64(x, w, g, s, p):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = F.conv2d(xt.permute(0, 3, 1, 2), wt, stride=s, padding=p)
    return torch.autograd.grad(y, (xt, wt), torch.tensor(g))


@pytest.mark.parametrize('geometry', sorted(GEOMETRIES))
def test_trunk_conv_grads_match_float64_autograd(geometry):
    k, s, p, cin, cout, side = GEOMETRIES[geometry]
    x, w, rng = _inputs(k, cin, cout, side)
    o = _out_side(side, k, s, p)
    g = rng.standard_normal((N, cout, o, o))
    want_dx, want_dw = _autograd64(x, w, g, s, p)
    dx, dw = _function_grads(x, w, g, s, p, torch.float32)
    assert dx.dtype == dw.dtype == torch.float32
    assert _ratio(dx, want_dx) <= TOL, geometry
    assert _ratio(dw, want_dw) <= TOL, geometry
    dx64, dw64 = _function_grads(x, w, g, s, p, torch.float64)
    assert _ratio(dx64, want_dx) <= 1e-12
    assert _ratio(dw64, want_dw) <= 1e-12


def _jax_trunk_conv(features: int, k: int, s: int, p: int):
    """The JAX trunk's conv: ``nn.Conv(use_bias=False)`` with symmetric
    explicit pads (joint_vae_tpu/models/resnet.py)."""
    import flax.linen as nn
    return nn.Conv(features, (k, k), (s, s), padding=[(p, p), (p, p)],
                   use_bias=False)


@pytest.mark.parametrize('geometry', sorted(GEOMETRIES))
def test_trunk_conv_grads_match_jax_vjp(geometry):
    """Forward, dx and dw of the port's float32 trunk conv (the module on
    the CPU, and the Function with the im2col dw) against ``jax.vjp`` of
    the JAX trunk's conv on the same inputs."""
    k, s, p, cin, cout, side = GEOMETRIES[geometry]
    x, w, rng = _inputs(k, cin, cout, side, seed=1)
    o = _out_side(side, k, s, p)
    g = rng.standard_normal((N, o, o, cout)).astype(np.float32)
    x32 = x.astype(np.float32)
    hwio = np.ascontiguousarray(w.transpose(2, 3, 1, 0)).astype(np.float32)
    import jax
    import jax.numpy as jnp
    mod = _jax_trunk_conv(cout, k, s, p)
    y, vjp = jax.vjp(lambda xx, kk: mod.apply({'params': {'kernel': kk}},
                                              xx),
                     jnp.asarray(x32), jnp.asarray(hwio))
    jdx, jdw = vjp(jnp.asarray(g))
    conv = TrunkConv(cin, cout, k, s, p)
    with torch.no_grad():
        conv.weight.copy_(TrunkConv.from_hwio(torch.from_numpy(hwio)))
    xt = torch.from_numpy(x32).requires_grad_(True)
    yt = conv(xt)
    assert _ratio(yt.detach(), y) <= TOL
    dx, dw = torch.autograd.grad(yt, (xt, conv.weight), torch.from_numpy(g))
    assert _ratio(dx, jdx) <= TOL, geometry
    assert _ratio(TrunkConv.to_hwio(dw), jdw) <= TOL, geometry
    dx, dw = _function_grads(x32, TrunkConv.from_hwio(torch.from_numpy(
        hwio)).numpy(), g.transpose(0, 3, 1, 2), s, p, torch.float32)
    assert _ratio(dx, jdx) <= TOL, geometry
    assert _ratio(TrunkConv.to_hwio(dw), jdw) <= TOL, geometry


def test_im2col_dw_over_two_chunks(monkeypatch):
    """A batch of 5 whose im2col copy is cut into chunks of 3 and 2
    images: the same dw as one chunk within float32 rounding, and within
    the tolerance of float64's."""
    k, s, p, cin, cout, side = GEOMETRIES['stem_7x7_s2_p3']
    x, w, rng = _inputs(k, cin, cout, side, seed=2)
    o = _out_side(side, k, s, p)
    g = rng.standard_normal((N, cout, o, o))
    _, want = _autograd64(x, w, g, s, p)
    _, whole = _function_grads(x, w, g, s, p, torch.float32)
    per_image = o * o * k * k * cin * 4
    monkeypatch.setattr(sgc, 'IM2COL_BYTES', 3 * per_image)
    calls = []
    real = sgc._im2col

    def counting(xp, *a, **kw):
        calls.append(xp.shape[0])
        return real(xp, *a, **kw)
    monkeypatch.setattr(sgc, '_im2col', counting)
    _, chunked = _function_grads(x, w, g, s, p, torch.float32)
    assert calls == [3, 2]
    assert _ratio(chunked, want) <= TOL
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-5)


def _same_grid_dw_before(x, g, th, tw, ph_lo, pw_lo):
    """The same-grid dw as it was written before ``im2col_dw``."""
    n, h, w, ci = x.shape
    co = g.shape[3]
    xp = F.pad(x, (0, 0, pw_lo, tw - 1 - pw_lo, ph_lo, th - 1 - ph_lo))
    k = th * tw * ci
    chunk = max(1, sgc.IM2COL_BYTES // (h * w * k * x.element_size()))
    acc = torch.promote_types(x.dtype, torch.float32)
    dw = torch.zeros((k, co), dtype=acc, device=x.device)
    for i in range(0, n, chunk):
        xc = xp[i:i + chunk]
        sn, sh, sw, sc = xc.stride()
        cols = xc.as_strided((xc.shape[0], h, w, th, tw, ci),
                             (sn, sh, sw, sh, sw, sc),
                             xc.storage_offset()).reshape(-1, k)
        gi = g[i:i + chunk].reshape(-1, co)
        if x.dtype == acc:
            dw.addmm_(cols.t(), gi)
        else:
            dw.addmm_(cols.t().to(acc), gi.to(acc))
    return dw.reshape(th, tw, ci, co).to(x.dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize('th,tw,ph_lo,pw_lo', [(3, 3, 1, 1), (5, 5, 2, 2),
                                               (2, 2, 0, 1), (4, 3, 1, 2)])
def test_same_grid_dw_unchanged_bit_for_bit(dtype, th, tw, ph_lo, pw_lo,
                                            monkeypatch):
    rng = np.random.default_rng(th * 10 + tw)
    x = torch.tensor(rng.standard_normal((6, 5, 7, 4)), dtype=dtype)
    g = torch.tensor(rng.standard_normal((6, 5, 7, 3)), dtype=dtype)
    # two chunks of images, as at the flagship's largest batches
    monkeypatch.setattr(sgc, 'IM2COL_BYTES',
                        4 * 5 * 7 * th * tw * 4 * x.element_size())
    got = sgc.same_grid_conv_dw(x, g, th, tw, ph_lo, pw_lo)
    want = _same_grid_dw_before(x, g, th, tw, ph_lo, pw_lo)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def _routes(device, dtype, monkeypatch):
    """One TrunkConv forward and backward on ``device``: the Function's
    ``im2col`` flags and the im2col products' strides, the gradients."""
    applied, products = [], []
    real_apply, real_dw = tconv.DeterministicConvFn.apply, tconv.im2col_dw
    monkeypatch.setattr(tconv.DeterministicConvFn, 'apply', staticmethod(
        lambda *a: applied.append(a[4]) or real_apply(*a)))
    monkeypatch.setattr(tconv, 'im2col_dw', lambda *a: products.append(
        a[4]) or real_dw(*a))
    conv = TrunkConv(4, 6, 3, 2, 1).to(device, dtype)
    with torch.no_grad():
        conv.weight.normal_()
    x = torch.randn(2, 7, 7, 4, dtype=dtype, device=device,
                    requires_grad=True)
    y = conv(x)
    assert y.shape == (2, 4, 4, 6) and y.dtype == dtype
    dx, dw = torch.autograd.grad(y.sum(), (x, conv.weight))
    assert dx.shape == x.shape and dw.shape == conv.weight.shape
    return applied, products, (conv, x, dx, dw)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_trunk_conv_routes_by_dtype(dtype, monkeypatch):
    """On the CPU: float32 and float64 through the Function with
    ``F.conv2d``'s weight gradient, its gradients bit for bit the autograd
    of ``F.conv2d``; bfloat16 through ``F.conv2d``."""
    applied, products, (conv, x, dx, dw) = _routes('cpu', dtype, monkeypatch)
    assert products == []
    assert applied == ([] if dtype == torch.bfloat16 else [False])
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, stride=2, padding=1)
    want = torch.autograd.grad(y.permute(0, 2, 3, 1).sum(),
                               (x, conv.weight))
    assert torch.equal(dx, want[0]) and torch.equal(dw, want[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the repeat is of the card\'s cuDNN '
                    'and cuBLAS')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_trunk_conv_routes_on_the_card(dtype, cuda_device, monkeypatch):
    """On a CUDA tensor float32 and float64 take the im2col weight
    gradient (stride 2 here), within 1e-4 of the CPU's float64 autograd;
    bfloat16 takes ``F.conv2d``."""
    applied, products, (conv, x, dx, dw) = _routes(cuda_device, dtype,
                                                   monkeypatch)
    if dtype == torch.bfloat16:
        assert applied == [] and products == []
        return
    assert applied == [True] and products == [2] and dw.is_contiguous()
    _, want = _autograd64(x.detach().cpu().double().numpy(),
                          conv.weight.detach().cpu().double().numpy(),
                          np.ones((2, 6, 4, 4)), 2, 1)
    assert _ratio(dw.cpu(), want) <= TOL


@pytest.mark.cuda
def test_resnet18_float32_step_repeats_bit_for_bit(cuda_device):
    """Two float32 ResNet flagship (resnet18 trunk) train steps at batch
    256 from one state, batch and noise, twice in one process: every
    parameter, BatchNorm statistic, Adam moment and metric bit-equal, and
    ``cudnn.deterministic`` off again afterwards."""
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.steps import make_train_step
    cfg = dataclasses.replace(flagship_config(), features='resnet18')
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 256) + cfg.input_shape)
                         .astype(np.float32)).to(cuda_device)
    y = torch.from_numpy(rng.integers(0, cfg.num_labels, (2, 256))
                         ).to(cuda_device)
    runs = []
    for _ in range(2):
        job = new_job(cfg, OptimizerConfig(lr=1e-4), seed=4,
                      device=cuda_device)
        step = make_train_step(job.model, job.opt_cfg)
        st, ms = job.state, []
        for i in range(2):
            st, m = step(st, x[i], y[i])
            ms.append(m.vector)
        torch.cuda.synchronize()
        o = job.state.opt_state
        tensors = {'p/' + k: v.clone() for k, v in
                   job.model.state_dict().items()}
        tensors.update({'mu/' + k: v.clone() for k, v in o.mu.items()})
        tensors.update({'nu/' + k: v.clone() for k, v in o.nu.items()})
        runs.append((tensors, torch.stack(ms).cpu()))
        del job, step, st
    differ = [k for k in runs[0][0]
              if not torch.equal(runs[0][0][k], runs[1][0][k])]
    assert not differ, differ
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.backends.cudnn.deterministic
