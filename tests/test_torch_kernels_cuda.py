"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and skips without one.  The file
imports neither jax nor the JAX package, so it runs on a machine that has
only torch:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

import pytest
import torch

from joint_vae_tpu_torch.device import set_float32_math
from joint_vae_tpu_torch.models.conv import ConvLayer, LayerPlan
from joint_vae_tpu_torch.ops.iws import (iws_combine, iws_combine_plain,
                                         kernel_splits)
from joint_vae_tpu_torch.ops.same_grid_conv import (SameGridConvFn,
                                                    same_grid_conv,
                                                    same_grid_conv_dx,
                                                    same_grid_conv_plain)

from torch_kernel_cases import (CONV_GEOMS, FLAGSHIP_DX_GEOMS, IWS_CASES,
                                WIDE_CONV_GEOM, conv_inputs, iws_case_id,
                                iws_case_inputs, iws_inputs)

# the conv gate's float32 tolerance (chip_smoke.py): |got - want| <=
# tol (|want| + rms(want)), sums of up to 1,600 products in another order
CONV_F32_TOL = 1e-4


def conv_gate(got, want, tol=CONV_F32_TOL):
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * want.square().mean().sqrt().item())


def close(got, want, tol):
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('geom', CONV_GEOMS + [WIDE_CONV_GEOM])
def test_same_grid_kernel_on_card(geom, dtype, cuda_device):
    dt = getattr(torch, dtype)
    n, h, w, ci, co, th, tw, ph, pw = geom
    x, k = conv_inputs(geom)
    xd = torch.from_numpy(x).to(cuda_device, dt)
    kd = torch.from_numpy(k).to(cuda_device, dt)
    before = same_grid_conv.launches
    got = same_grid_conv(xd, kd, ph, pw)
    torch.cuda.synchronize()
    assert same_grid_conv.launches == before + 1
    want = same_grid_conv_plain(xd, kd, ph, pw)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    close(got.float(), want.float(), tol)


@pytest.mark.cuda
def test_subpixel_layer_on_card(cuda_device):
    """A stride-2 deconv through the sub-pixel route (one same-grid launch
    on the packed kernel) against F.conv_transpose2d in full float32."""
    import torch.nn.functional as F
    set_float32_math()
    n, h, ci, co, k, p, s, op = 4, 8, 64, 64, 5, 2, 2, 1
    oh = (h - 1) * s - 2 * p + k + op
    pl = LayerPlan(ltype='deconv', out_channels=co, kernel_size=k, padding=p,
                   stride=s, output_padding=op, out_shape=(co, oh, oh))
    layer = ConvLayer(pl, ci, h, h).to(cuda_device)
    assert layer.route == 'subpixel'
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        layer.weight.copy_(0.1 * torch.randn(layer.weight.shape, generator=g))
        layer.bias.copy_(torch.randn(co, generator=g))
        x = torch.randn((n, h, h, ci), generator=g).to(cuda_device)
        before = same_grid_conv.launches
        got = layer(x)
        torch.cuda.synchronize()
        assert same_grid_conv.launches == before + 1
        wt = torch.flip(layer.weight, (0, 1)).permute(2, 3, 0, 1)
        want = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, layer.bias,
                                  stride=s, padding=p, output_padding=op)
    close(got, want.permute(0, 2, 3, 1), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('ref_mode', [True, False])
@pytest.mark.parametrize('shape', [(16, 512, 128, 100), (3, 137, 16, 37)])
def test_iws_kernel_on_card(shape, ref_mode, cuda_device):
    L, N, K, C = shape
    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in iws_inputs(L, N, C, K))
    before = iws_combine.launches
    got = iws_combine(*args, ref_mode=ref_mode)
    torch.cuda.synchronize()
    assert iws_combine.launches == before + 1
    # elementwise, far below the sum term (at least 1/L in reference mode)
    torch.testing.assert_close(
        got, iws_combine_plain(*args, ref_mode=ref_mode), rtol=1e-6, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('ref_mode', [True, False])
@pytest.mark.parametrize('case', IWS_CASES, ids=iws_case_id)
def test_iws_case_on_card(case, ref_mode, cuda_device):
    """The shared cases, prior means at scale 17 included, at the unchanged
    elementwise gate; cases with few (C, N) tiles split l across the
    blocks of a cluster."""
    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in iws_case_inputs(case))
    before = iws_combine.launches
    got = iws_combine(*args, ref_mode=ref_mode)
    torch.cuda.synchronize()
    assert iws_combine.launches == before + 1
    torch.testing.assert_close(
        got, iws_combine_plain(*args, ref_mode=ref_mode), rtol=1e-6, atol=1e-4)


@pytest.mark.cuda
def test_iws_kernel_splits_and_unaligned_rows(cuda_device):
    """L=128 over two (C, N) tiles takes a cluster of 8 or more; z and the means at
    an offset of one float take the 4-byte copies."""
    L, N, C, K = 128, 17, 10, 32
    assert kernel_splits(L, N, K, C) >= 8
    z, lp, mean, s2, ldp = (torch.from_numpy(a).to(cuda_device)
                            for a in iws_inputs(L, N, C, K, seed=3))
    zu = torch.empty(z.numel() + 1, device=cuda_device)[1:].view(z.shape)
    mu = torch.empty(mean.numel() + 1, device=cuda_device)[1:].view(mean.shape)
    zu.copy_(z)
    mu.copy_(mean)
    assert zu.is_contiguous() and zu.data_ptr() % 16 == 4
    got = iws_combine(zu, lp, mu, s2, ldp)
    torch.testing.assert_close(got, iws_combine_plain(z, lp, mean, s2, ldp),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.cuda
def test_iws_wrapper_refuses_on_card(cuda_device):
    """What the kernel does not take raises, and nothing is counted: the
    wrapper refuses types, layouts and devices, the kernel's planner a K
    whose means and z slabs overflow shared memory (K > 352)."""
    def args(L=2, N=5, C=3, K=4, **kw):
        a = dict(z=torch.zeros(L, N, K), log_pxq=torch.zeros(L, N),
                 mean=torch.zeros(C, K), s2=torch.ones(C),
                 log_det_prior=torch.zeros(C))
        a = {k: v.to(cuda_device) for k, v in a.items()}
        a.update(kw)
        return a
    before = iws_combine.launches
    bad = [args(z=torch.zeros(2, 5, 4, device=cuda_device, dtype=torch.float64)),
           args(z=torch.zeros(2, 4, 5, device=cuda_device).transpose(1, 2)),
           args(K=353),
           args(s2=torch.ones(3))]                     # one input on the CPU
    for a in bad:
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            iws_combine(**a)
    assert iws_combine.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('site', sorted(FLAGSHIP_DX_GEOMS))
def test_conv_fn_grads_on_card(site, cuda_device):
    """SameGridConvFn under autograd at the flagship's dx geometries: dx
    on the kernel (one dx launch, ci and co swapped: conv_6's 3 -> 32),
    dw on the library, both against autograd through the plain version."""
    set_float32_math()
    geom = FLAGSHIP_DX_GEOMS[site]
    n, h, w, ci, co, th, tw, ph, pw = geom
    x, k = (torch.from_numpy(a).to(cuda_device) for a in conv_inputs(geom))
    g = 0.05 * torch.randn((n, h, w, co), device=cuda_device,
                           generator=torch.Generator(cuda_device).manual_seed(1))
    xk = [x.clone().requires_grad_(), k.clone().requires_grad_()]
    before = (same_grid_conv.launches, same_grid_conv_dx.launches)
    y = SameGridConvFn.apply(xk[0], xk[1], ph, pw)
    dx, dw = torch.autograd.grad(y, xk, g)
    torch.cuda.synchronize()
    assert (same_grid_conv.launches, same_grid_conv_dx.launches) == (
        before[0] + 1, before[1] + 1)
    xp = [x.clone().requires_grad_(), k.clone().requires_grad_()]
    want_dx, want_dw = torch.autograd.grad(
        same_grid_conv_plain(xp[0], xp[1], ph, pw), xp, g)
    conv_gate(dx, want_dx)
    conv_gate(dw, want_dw)


@pytest.mark.cuda
@pytest.mark.parametrize('geom', [(8, 32, 32, 32, 32, 5, 2, 2),    # conv_1
                                  (8, 16, 16, 64, 64, 5, 2, 2),    # conv_3
                                  (8, 8, 8, 64, 200, 7, 1, 0)])    # conv_4
def test_library_conv_grads_on_card(geom, cuda_device):
    """The flagship's convs that stay on the library (cuDNN, forward and
    both gradients under autograd) in float32 against float64."""
    import torch.nn.functional as F
    set_float32_math()
    n, h, w, ci, co, k, s, p = geom
    gen = torch.Generator(cuda_device).manual_seed(2)
    x = torch.rand((n, h, w, ci), device=cuda_device, generator=gen)
    wt = torch.randn((co, ci, k, k), device=cuda_device, generator=gen) / k
    got, want = [], []
    for dt, out in ((torch.float32, got), (torch.float64, want)):
        xk = [x.to(dt).requires_grad_(), wt.to(dt).requires_grad_()]
        y = F.conv2d(xk[0].permute(0, 3, 1, 2), xk[1], stride=s, padding=p)
        g = torch.cos(torch.arange(y.numel(), device=cuda_device,
                                   dtype=dt)).reshape(y.shape)
        out += [y, *torch.autograd.grad(y, xk, g)]
    for a, b in zip(got, want):
        conv_gate(a.double(), b)


@pytest.mark.cuda
def test_full_width_backward_on_card(cuda_device):
    """One backward through the full-width flagship on the card: 8 forward
    and 7 dx launches, and every parameter that trains gets a finite,
    nonzero gradient (nothing dropped on the way through the kernel)."""
    from joint_vae_tpu_torch.models.cvnet import CVNet, flagship_config, init_weights
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.ops.sigma import init_sigma_state
    from joint_vae_tpu_torch.train.state import grad_mask
    set_float32_math()
    cfg = flagship_config()
    model = init_weights(CVNet(cfg), 0).to(cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(0)
    x = torch.rand((16,) + cfg.input_shape, device=cuda_device, generator=gen)
    y = torch.randint(0, cfg.num_labels, (16,), device=cuda_device,
                      generator=gen)
    same_grid_conv.launches = same_grid_conv_dx.launches = 0
    out = evaluate(model, x, y, sigma_state=init_sigma_state(cfg.sigma_cfg,
                                                             cuda_device),
                   train=True, with_beta=True, generator=gen)
    torch.mean(out.losses['total']).backward()
    torch.cuda.synchronize()
    assert (same_grid_conv.launches, same_grid_conv_dx.launches) == (8, 7)
    mask = grad_mask(model)
    for name, p in model.named_parameters():
        if not mask[name]:
            continue
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert torch.count_nonzero(p.grad) > 0, name
