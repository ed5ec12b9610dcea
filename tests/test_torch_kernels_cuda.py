"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and skips without one.  The file
imports neither jax nor the JAX package, so it runs on a machine that has
only torch:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

import pytest
import torch

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
