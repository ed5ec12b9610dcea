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
from joint_vae_tpu_torch.train.graphs import batches_run, reset_steps_run

from torch_kernel_cases import (CONV_GEOMS, FLAGSHIP_DX_GEOMS,
                                FLAGSHIP_SITE_GEOMS, IMAGENET64_SITE_GEOMS,
                                IWS_CASES,
                                STRESS_CONV_GEOMS, WIDE_CONV_GEOM,
                                conv_inputs, iws_case_id, iws_case_inputs,
                                iws_inputs)

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
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('geom', STRESS_CONV_GEOMS)
def test_same_grid_kernel_tiling_on_card(geom, dtype, cuda_device):
    """The tensor-core kernel's N tiles (8..128, co 256 in two), M tails,
    partial and folded channel chunks, asymmetric pads and the float32
    co < 8 kernel: forward and input gradient against their plain
    versions, one launch each."""
    from joint_vae_tpu_torch.ops.same_grid_conv import same_grid_conv_dx_plain
    dt = getattr(torch, dtype)
    n, h, w, ci, co, th, tw, ph, pw = geom
    x, k = conv_inputs(geom)
    xd = torch.from_numpy(x).to(cuda_device, dt)
    kd = torch.from_numpy(k).to(cuda_device, dt)
    g = torch.from_numpy(conv_inputs((n, h, w, co, ci, th, tw, ph, pw),
                                     seed=1)[0]).to(cuda_device, dt)
    before = (same_grid_conv.launches, same_grid_conv_dx.launches)
    got = same_grid_conv(xd, kd, ph, pw)
    dx = same_grid_conv_dx(g, kd, ph, pw)
    torch.cuda.synchronize()
    assert (same_grid_conv.launches, same_grid_conv_dx.launches) == (
        before[0] + 1, before[1] + 1)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    close(got.float(), same_grid_conv_plain(xd, kd, ph, pw).float(), tol)
    close(dx.float(), same_grid_conv_dx_plain(g, kd, ph, pw).float(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('site', sorted(FLAGSHIP_SITE_GEOMS))
def test_flagship_sites_at_train_batch_on_card(site, dtype, cuda_device):
    """Each of the flagship's eight same-grid sites at the train step's
    batch (1024, L=1) in both dtypes, the packed sub-pixel kernels as
    launched: the forward, and the input gradient where a step takes one
    (not conv_0, which reads the data), against their plain versions."""
    from joint_vae_tpu_torch.ops.same_grid_conv import same_grid_conv_dx_plain
    dt = getattr(torch, dtype)
    n, h, w, ci, co, th, tw, ph, pw = (1024,) + FLAGSHIP_SITE_GEOMS[site][1:]
    gen = torch.Generator(cuda_device).manual_seed(4)
    x = torch.rand((n, h, w, ci), device=cuda_device, generator=gen).to(dt)
    k = (torch.randn((th, tw, ci, co), device=cuda_device, generator=gen)
         / (th * tw * ci) ** 0.5).to(dt)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    close(same_grid_conv(x, k, ph, pw).float(),
          same_grid_conv_plain(x, k, ph, pw).float(), tol)
    if site != 'features_stack.conv_0':
        g = (0.05 * torch.randn((n, h, w, co), device=cuda_device,
                                generator=gen)).to(dt)
        close(same_grid_conv_dx(g, k, ph, pw).float(),
              same_grid_conv_dx_plain(g, k, ph, pw).float(), tol)


# the conv's tolerances in chip_smoke.py's form, |got - want| <= tol
# (|want| + rms(want)): float32 1e-4, bfloat16 two bf16 ulps
CONV_TOL = {torch.float32: CONV_F32_TOL, torch.bfloat16: 1.6e-2}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('site', sorted(IMAGENET64_SITE_GEOMS))
def test_imagenet64_sites_on_card(site, dtype, cuda_device):
    """Four of imagenet64's same-grid sites in both dtypes (ci 512 on a
    4x4 grid, the k=4 sub-pixel deconv's packed 1,024 channels, the 5x5
    head): the forward and the input gradient against their plain
    versions, one launch each, in the conv gate's form."""
    from joint_vae_tpu_torch.ops.same_grid_conv import same_grid_conv_dx_plain
    dt = getattr(torch, dtype)
    n, h, w, ci, co, th, tw, ph, pw = IMAGENET64_SITE_GEOMS[site]
    gen = torch.Generator(cuda_device).manual_seed(6)
    x = torch.rand((n, h, w, ci), device=cuda_device, generator=gen).to(dt)
    k = (torch.randn((th, tw, ci, co), device=cuda_device, generator=gen)
         / (th * tw * ci) ** 0.5).to(dt)
    g = (0.05 * torch.randn((n, h, w, co), device=cuda_device,
                            generator=gen)).to(dt)
    before = (same_grid_conv.launches, same_grid_conv_dx.launches)
    y = same_grid_conv(x, k, ph, pw)
    dx = same_grid_conv_dx(g, k, ph, pw)
    torch.cuda.synchronize()
    assert (same_grid_conv.launches, same_grid_conv_dx.launches) == (
        before[0] + 1, before[1] + 1)
    conv_gate(y.float(), same_grid_conv_plain(x, k, ph, pw).float(),
              CONV_TOL[dt])
    conv_gate(dx.float(), same_grid_conv_dx_plain(g, k, ph, pw).float(),
              CONV_TOL[dt])


@pytest.mark.cuda
def test_imagenet64_subpixel_deconv_layer_on_card(cuda_device):
    """imagenet64's deconv_1 (k=4, s=2, p=1: 4x4, 512 -> 256 channels to
    8x8) through the sub-pixel route against F.conv_transpose2d in full
    float32: one same-grid launch on the packed kernel."""
    import torch.nn.functional as F
    set_float32_math()
    n, h, ci, co, k, p, s = 16, 4, 512, 256, 4, 1, 2
    pl = LayerPlan(ltype='deconv', out_channels=co, kernel_size=k, padding=p,
                   stride=s, output_padding=0, out_shape=(co, 2 * h, 2 * h))
    layer = ConvLayer(pl, ci, h, h).to(cuda_device)
    assert layer.route == 'subpixel'
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=g)
                           / (k * k * ci) ** 0.5)
        layer.bias.copy_(torch.randn(co, generator=g))
        x = torch.rand((n, h, h, ci), generator=g).to(cuda_device)
        before = same_grid_conv.launches
        got = layer(x)
        torch.cuda.synchronize()
        assert same_grid_conv.launches == before + 1
        wt = torch.flip(layer.weight, (0, 1)).permute(2, 3, 0, 1)
        want = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, layer.bias,
                                  stride=s, padding=p)
    conv_gate(got, want.permute(0, 2, 3, 1))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_same_grid_kernel_in_chunks_on_card(dtype, cuda_device, monkeypatch):
    """A batch beyond the kernel's int32 shapes (here MAX_ELEMS lowered to
    one image) runs one launch per range of images, forward and dx,
    bit-equal to the single launch."""
    import joint_vae_tpu_torch.ops.same_grid_conv as sgc
    dt = getattr(torch, dtype)
    geom = CONV_GEOMS[2]
    n, h, w, ci, co, th, tw, ph, pw = geom
    x, k = conv_inputs(geom)
    xd = torch.from_numpy(x).to(cuda_device, dt)
    kd = torch.from_numpy(k).to(cuda_device, dt)
    one, dx_one = same_grid_conv(xd, kd, ph, pw), same_grid_conv_dx(
        same_grid_conv(xd, kd, ph, pw), kd, ph, pw)
    monkeypatch.setattr(sgc, 'MAX_ELEMS', h * w * max(ci, co))
    chunks = len(sgc.batch_chunks(n, h * w * max(ci, co)))
    assert chunks == n > 1
    before = (same_grid_conv.launches, same_grid_conv_dx.launches)
    got = same_grid_conv(xd, kd, ph, pw)
    dx = same_grid_conv_dx(one, kd, ph, pw)
    torch.cuda.synchronize()
    assert (same_grid_conv.launches - before[0],
            same_grid_conv_dx.launches - before[1]) == (chunks, chunks)
    assert torch.equal(got, one) and torch.equal(dx, dx_one)


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
@pytest.mark.parametrize('shape', [(16, 512, 128, 100), (3, 137, 16, 37),
                                   (16, 137, 353, 37), (16, 512, 512, 100),
                                   (128, 512, 1024, 10), (128, 64, 1025, 10)])
def test_iws_kernel_on_card(shape, ref_mode, cuda_device):
    """One launch at each shape, K > 352 on the streamed kernel: K=353 the
    first K the resident one cannot hold (the 4-byte copies), 512 and 1024
    the named sections [fashion] and [fashion-vgg16] at their test L=128."""
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
@pytest.mark.parametrize('ref_mode', [True, False])
@pytest.mark.parametrize('shape', [(16, 512, 128, 100, 2),
                                   (16, 272, 128, 100, 4),
                                   (128, 64, 128, 100, 2)])
def test_iws_kernel_on_a_class_block_on_card(shape, ref_mode, cuda_device):
    """A mesh that splits the classes over 'model' runs the combine on
    each rank's block of classes: each block equals that block of the
    whole combine, bit for bit, whatever cluster split either launch
    takes."""
    L, N, K, C, parts = shape
    z, lp, mean, s2, ldp = (torch.from_numpy(a).to(cuda_device)
                            for a in iws_inputs(L, N, C, K, mean_scale=17))
    whole = iws_combine(z, lp, mean, s2, ldp, ref_mode=ref_mode)
    per = C // parts
    for i in range(parts):
        blk = slice(i * per, (i + 1) * per)
        got = iws_combine(z, lp, mean[blk].contiguous(), s2[blk].contiguous(),
                          ldp[blk].contiguous(), ref_mode=ref_mode)
        torch.cuda.synchronize()
        assert torch.equal(got, whole[blk]), (i, kernel_splits(L, N, K, per),
                                              kernel_splits(L, N, K, C))


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
    wrapper refuses types, layouts and devices."""
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
@pytest.mark.parametrize('site', sorted(FLAGSHIP_DX_GEOMS))
def test_conv_fn_grads_bf16_at_train_batch_on_card(site, cuda_device):
    """SameGridConvFn in bfloat16 at the train step's batch (1024, L=1):
    dx on the kernel against its plain version in the conv's bfloat16
    form (two bfloat16 ulps), dw summed in float32 and rounded once,
    within half a bfloat16 ulp of the float64 sum of the same inputs plus
    the float32 form's absolute term."""
    from joint_vae_tpu_torch.ops.same_grid_conv import (
        bf16_launches, same_grid_conv_dw, same_grid_conv_dx_plain)
    n, h, w, ci, co, th, tw, ph, pw = (1024,) + FLAGSHIP_DX_GEOMS[site][1:]
    gen = torch.Generator(cuda_device).manual_seed(3)
    x = torch.rand((n, h, w, ci), device=cuda_device, generator=gen)
    k = torch.randn((th, tw, ci, co), device=cuda_device,
                    generator=gen) / (th * tw * ci) ** 0.5
    g = 0.05 * torch.randn((n, h, w, co), device=cuda_device, generator=gen)
    x, k, g = x.bfloat16(), k.bfloat16(), g.bfloat16()
    xk = [x.clone().requires_grad_(), k.clone().requires_grad_()]
    before = (same_grid_conv.launches, same_grid_conv_dx.launches)
    before16 = dict(bf16_launches)
    y = SameGridConvFn.apply(xk[0], xk[1], ph, pw)
    dx, dw = torch.autograd.grad(y, xk, g)
    torch.cuda.synchronize()
    assert (same_grid_conv.launches, same_grid_conv_dx.launches) == (
        before[0] + 1, before[1] + 1)
    assert bf16_launches == {name: n + 1 for name, n in before16.items()}
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    want_dx = same_grid_conv_dx_plain(g, k, ph, pw).float()
    conv_gate(dx.float(), want_dx, tol=1.6e-2)
    want_dw = same_grid_conv_dw(x.double(), g.double(), th, tw, ph, pw)
    bound = (2.0 ** -8 * want_dw.abs()
             + CONV_F32_TOL * want_dw.square().mean().sqrt())
    assert bool(((dw.double() - want_dw).abs() <= bound).all())


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


@pytest.mark.cuda
def test_conv_0_dx_on_card(cuda_device):
    """The input gradient at the features' first conv (3 -> 32, 5x5 on
    32x32), which only ODIN takes (training never needs it: conv_0 reads
    the data): its dx is a same-grid conv 32 -> 3 on the kernel."""
    set_float32_math()
    n, h, w, ci, co, th, tw, ph, pw = 8, 32, 32, 3, 32, 5, 5, 2, 2
    x, k = (torch.from_numpy(a).to(cuda_device) for a in conv_inputs(
        (n, h, w, ci, co, th, tw, ph, pw)))
    g = 0.05 * torch.randn((n, h, w, co), device=cuda_device,
                           generator=torch.Generator(cuda_device).manual_seed(3))
    xg = x.clone().requires_grad_()
    before = same_grid_conv_dx.launches
    dx, = torch.autograd.grad(SameGridConvFn.apply(xg, k, ph, pw), xg, g)
    torch.cuda.synchronize()
    assert same_grid_conv_dx.launches == before + 1
    xp = x.clone().requires_grad_()
    want, = torch.autograd.grad(same_grid_conv_plain(xp, k, ph, pw), xp, g)
    conv_gate(dx, want)


@pytest.mark.cuda
@pytest.mark.parametrize('two_sided', [False, 'around-mean', (4, 1)], ids=str)
def test_roc_on_card_matches_cpu(two_sided, cuda_device):
    """The ROC on the card against the same call on the CPU: rates and AUC
    within 1e-6, thresholds equal."""
    from joint_vae_tpu_torch.ops.roc import roc_curve
    g = torch.Generator().manual_seed(4)
    ins = torch.randn(5000, generator=g) + 1.0
    outs = 1.5 * torch.randn(3000, generator=g)
    ins[:500] = torch.round(ins[:500], decimals=1)        # ties
    perm = torch.randperm(5000, generator=g)
    kw = dict(two_sided=two_sided, validation=1000 if two_sided else 0,
              perm=perm)
    got = roc_curve(ins.to(cuda_device), outs.to(cuda_device), **kw)
    want = roc_curve(ins, outs, **kw)
    for k in ('auc', 'fpr', 'tpr', 'precision'):
        close(got[k].cpu(), want[k], 1e-6)
    for k in ('thresholds_low', 'thresholds_up'):
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_engine_launches_at_a_ragged_tail(tmp_path, cuda_device):
    """The OOD engine on the full-width flagship over sets of 100 images at
    batch 64 (a full batch and a ragged 36): one combine and 8 conv
    launches per batch of each set; then the recorder tier serves the same
    call and accuracy with no launch."""
    import numpy as np
    from joint_vae_tpu_torch.data.loaders import ArrayDataset
    from joint_vae_tpu_torch.evals.engines import (accuracy,
                                                   ood_detection_rates)
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job, save_job
    cfg = flagship_config()
    job = new_job(cfg, seed=0, device=cuda_device)
    save_job(job, str(tmp_path / 'job'))
    rng = np.random.default_rng(0)
    sets = [ArrayDataset(rng.uniform(0, 1, (100,) + cfg.input_shape)
                         .astype(np.float32), rng.integers(0, 100, 100), name)
            for name in ('test', 'ood')]
    kw = dict(batch_size=64, method=['iws', 'elbo', 'iws-2s'])
    same_grid_conv.launches = iws_combine.launches = 0
    res = ood_detection_rates(job, sets[0], sets[1:], **kw)
    torch.cuda.synchronize()
    assert (same_grid_conv.launches, iws_combine.launches) == (2 * 2 * 8, 2 * 2)
    assert all(np.isfinite(r['auc']) for r in res['ood'].values())
    same_grid_conv.launches = iws_combine.launches = 0
    job.ood_results.clear()
    again = ood_detection_rates(job, sets[0], sets[1:],
                                from_where=('recorders',), **kw)
    acc = accuracy(job, sets[0], batch_size=64, from_where=('recorders',))
    assert (same_grid_conv.launches, iws_combine.launches) == (0, 0)
    assert set(acc) == set(cfg.predict_methods)
    for m, r in res['ood'].items():
        assert abs(again['ood'][m]['auc'] - r['auc']) <= 1e-6, m


@pytest.mark.cuda
def test_test_cli_rehard_on_card(tmp_path, cuda_device, monkeypatch):
    """``cli.test --compute rehard`` on the full-width flagship over 32
    images of cifar100 and of cifar10 at batch 16: 8 conv and 1 combine
    launches per batch of its four set passes (accuracy, the OOD engine
    over both sets, misclassification) that ran eagerly or was captured
    (each engine's batches are scoring graphs; a replay calls no
    wrapper); then the same run on the CPU, the latent noise injected
    alike from one numpy array per shape (on the card, copied there once
    per shape, before any capture reads it): the saved accuracies, rates
    and AUCs within 1e-6."""
    import json
    import shutil
    import zlib
    import numpy as np
    import joint_vae_tpu_torch.evals.odin as odin
    import joint_vae_tpu_torch.models.evaluate as evaluate
    from joint_vae_tpu_torch.cli import test as test_cli
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job, save_job

    made = {}

    def noise(mu, log_var, L, dist='gaussian', sampled=True, *, eps=None,
              generator=None):
        shape = (L + 1,) + tuple(mu.shape)
        if (shape, mu.device) not in made:
            rng = np.random.default_rng(zlib.crc32(repr(shape).encode()))
            e = rng.standard_normal(shape).astype(np.float32)
            e[0] = 0.0
            made[shape, mu.device] = torch.from_numpy(e).to(mu.device)
        e = made[shape, mu.device]
        z = mu[None] + torch.exp(0.5 * log_var)[None] * e * float(sampled)
        return z, e[1:]
    monkeypatch.setattr(evaluate, 'reparameterize', noise)
    monkeypatch.setattr(odin, 'reparameterize', noise)
    job = new_job(flagship_config(), seed=0, device=cuda_device)
    job.training_parameters['set'] = 'cifar100'
    roots = {dev: str(tmp_path / dev) for dev in ('cuda', 'cpu')}
    save_job(job, roots['cuda'] + '/job')
    shutil.copytree(roots['cuda'], roots['cpu'])
    argv = ['--compute', 'rehard', '--sets', 'cifar100', 'cifar10',
            '-t', '32', '-M', '16']
    same_grid_conv.launches = iws_combine.launches = 0
    reset_steps_run()
    assert test_cli.main(['--job-dir', roots['cuda']] + argv) == 0
    torch.cuda.synchronize()
    assert sum(r['eager'] + r['replayed']
               for r in batches_run.values()) == 4 * 2
    batches = sum(r['eager'] + r['captured'] for r in batches_run.values())
    assert (same_grid_conv.launches, iws_combine.launches) == (8 * batches,
                                                               batches)
    assert test_cli.main(['--job-dir', roots['cpu'], '--device', 'cpu']
                         + argv) == 0
    worst = 0.0
    for name in ('test.json', 'ood.json'):
        got, want = (json.load(open(roots[dev] + '/job/' + name))['0']
                     for dev in ('cuda', 'cpu'))

        def walk(g, w, key=None):
            nonlocal worst
            if isinstance(w, dict):
                assert g.keys() == w.keys()
                for k in w:
                    walk(g[k], w[k], k)
            elif key in ('accuracy', 'auc', 'fpr', 'precision', 'recall'):
                err = float(np.max(np.abs(np.subtract(g, w))))
                assert err <= 1e-6, (name, key, err)
                worst = max(worst, err)
        walk(got, want)
    assert worst <= 1e-6


@pytest.mark.cuda
def test_wim_finetune_on_card(cuda_device):
    """WIM fine-tuning on the full-width flagship: one both-prior
    evaluation of 8 inputs at L=16 launches 16 convs and 1 combine (the
    original prior only) and its losses and twins equal the CPU's within
    1e-4 + 2e-6 |cpu|; then one fine-tune step on 8 in-distribution and 8
    moving-set inputs launches the conv forward at 16 sites and its dx at
    14 (both halves) and no combine, leaves the prior alone, and its
    metrics equal the CPU's with the same noise (1e-4 relative).  The
    evaluation comes first: after a step the weights differ by Adam's
    rounding between the devices (chip_smoke.py's docstring)."""
    import numpy as np
    from joint_vae_tpu_torch.ft.wim import WIMJob
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import build_optimizer
    from joint_vae_tpu_torch.train.state import named_params
    set_float32_math()
    cfg = flagship_config()
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (3, 8) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_labels, 8)
    eps = rng.standard_normal((cfg.latent_sampling + 1, 8, cfg.latent_dim)
                              ).astype(np.float32)
    eps_eval = rng.standard_normal((cfg.test_latent_sampling + 1, 8,
                                    cfg.latent_dim)).astype(np.float32)
    eps[0] = eps_eval[0] = 0.0
    got = {}
    for dev in (cuda_device, torch.device('cpu')):
        job = new_job(cfg, seed=0, device=dev)
        wim = WIMJob(job=job)
        wim.set_alternate_prior(init_mean=8.0, num_priors=1, seed=7)
        prior = {k: v.detach().clone() for k, v in job.model.prior().items()}
        tx = build_optimizer(job.opt_cfg)
        job.state.opt_state = tx.init(named_params(job.model))
        t = lambda a: torch.from_numpy(a).to(dev)
        same_grid_conv.launches = same_grid_conv_dx.launches = 0
        iws_combine.launches = 0
        _, _, losses, _ = wim.evaluate_on_both_priors(
            t(x[2]), sigma_state=job.sigma_state, decode_mean=False,
            eps=t(eps_eval))
        if dev.type == 'cuda':
            torch.cuda.synchronize()
            assert (same_grid_conv.launches, iws_combine.launches) == (16, 1)
        same_grid_conv.launches = iws_combine.launches = 0
        _, m = wim.finetune_batch(job.state, t(x[0]), t(y), t(x[1]), 0.1,
                                  tx=tx, train_L=cfg.latent_sampling,
                                  eps=t(eps))
        if dev.type == 'cuda':
            torch.cuda.synchronize()
            assert (same_grid_conv.launches, same_grid_conv_dx.launches,
                    iws_combine.launches) == (16, 14, 0)
        for k, v in job.model.prior().items():
            assert torch.equal(v, prior[k]), k
        got[dev.type] = ({k: v.item() for k, v in m.items()},
                         {k: v.cpu() for k, v in losses.items()})
    (m_gpu, l_gpu), (m_cpu, l_cpu) = got['cuda'], got['cpu']
    for k in m_cpu:
        assert abs(m_gpu[k] - m_cpu[k]) <= 1e-4 * abs(m_cpu[k]), k
    assert set(l_gpu) == set(l_cpu) and 'total@' in l_cpu
    for k in l_cpu:
        torch.testing.assert_close(l_gpu[k], l_cpu[k], rtol=2e-6, atol=1e-4)


@pytest.mark.cuda
def test_resnet_flagship_on_card(cuda_device):
    """The flagship with a full-width resnet18 trunk (cuDNN): an evaluate
    per class launches the conv at the decoder's 6 sites and the combine
    once, card against CPU within the serving tolerance (|card - cpu| <=
    1e-4 + 2e-6 |cpu|); a train step launches 6 forward and 6 dx."""
    import dataclasses
    import numpy as np
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.models.evaluate import evaluate
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.steps import make_train_step
    cfg = dataclasses.replace(flagship_config(), features='resnet18')
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (16,) + cfg.input_shape).astype(np.float32)
    eps = rng.standard_normal((cfg.test_latent_sampling + 1, 16,
                               cfg.latent_dim)).astype(np.float32)
    eps[0] = 0.0
    losses = {}
    for dev in (cuda_device, torch.device('cpu')):
        job = new_job(cfg, seed=0, device=dev)
        out = evaluate(job.model, torch.from_numpy(x).to(dev), None,
                       sigma_state=job.sigma_state,
                       eps=torch.from_numpy(eps).to(dev))
        losses[dev.type] = {k: v.cpu() for k, v in out.losses.items()}
    for k, want in losses['cpu'].items():
        torch.testing.assert_close(losses['cuda'][k], want, rtol=2e-6,
                                   atol=1e-4, msg=k)
    job = new_job(cfg, seed=0, device=cuda_device)
    step = make_train_step(job.model, job.opt_cfg)
    y = torch.from_numpy(rng.integers(0, 100, 32)).to(cuda_device)
    xb = torch.from_numpy(rng.uniform(0, 1, (32,) + cfg.input_shape)
                          .astype(np.float32)).to(cuda_device)
    same_grid_conv.launches = iws_combine.launches = 0
    evaluate(job.model, xb, None, sigma_state=job.sigma_state)
    torch.cuda.synchronize()
    assert (same_grid_conv.launches, iws_combine.launches) == (6, 1)
    same_grid_conv.launches = same_grid_conv_dx.launches = 0
    _, m = step(job.state, xb, y)
    torch.cuda.synchronize()
    assert (same_grid_conv.launches, same_grid_conv_dx.launches) == (6, 6)
    assert torch.isfinite(m['total'])
