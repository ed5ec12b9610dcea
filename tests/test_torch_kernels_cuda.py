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
from joint_vae_tpu_torch.ops.iws import iws_combine, iws_combine_plain
from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                    same_grid_conv_plain)

from torch_kernel_cases import (CONV_GEOMS, WIDE_CONV_GEOM, conv_inputs,
                                iws_inputs)


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
