"""The port's two kernel modules against the JAX package's TPU kernels.

On the CPU the wrappers take their plain PyTorch versions, which are held
against the JAX Pallas kernels in interpret mode and against the XLA
references: the same-grid conv (``pallas_conv._same_grid_conv`` /
``_xla_conv``, asymmetric pads and a 3-channel head included) and the
IWAE combine (``iws_fused(interpret=True)`` / ``iws_reference_combine``,
on the four cases of tests/test_pallas.py and on the shared ``IWS_CASES``,
prior means at the flagship's scale 17 included).  Launch counters stay 0 on
the CPU.  The CUDA kernels themselves are held against the plain versions
on the card by test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import joint_vae_tpu.ops.pallas_conv as pc
from joint_vae_tpu.ops.pallas_kernels import iws_fused, iws_reference_combine

from joint_vae_tpu_torch.ops.iws import iws_combine, iws_combine_plain
from joint_vae_tpu_torch.ops.same_grid_conv import (same_grid_conv,
                                                    same_grid_conv_plain)

from torch_kernel_cases import (CONV_GEOMS, IWS_CASES, conv_inputs,
                                iws_case_id, iws_case_inputs, iws_inputs)
from torch_port_util import close

@pytest.fixture
def fresh_counters():
    same_grid_conv.launches = 0
    iws_combine.launches = 0
    yield
    assert same_grid_conv.launches == 0
    assert iws_combine.launches == 0


@pytest.mark.parametrize('geom', CONV_GEOMS)
def test_same_grid_plain_matches_jax(geom, fresh_counters):
    n, h, w, ci, co, th, tw, ph, pw = geom
    x, k = conv_inputs(geom)
    got = same_grid_conv(torch.from_numpy(x), torch.from_numpy(k), ph, pw)
    assert tuple(got.shape) == (n, h, w, co)
    close(got, same_grid_conv_plain(torch.from_numpy(x), torch.from_numpy(k),
                                    ph, pw), 0)
    xla = pc._xla_conv(jnp.asarray(x), jnp.asarray(k), ph, th - 1 - ph,
                       pw, tw - 1 - pw)
    close(got, xla, 1e-5, 'vs lax.conv')
    pallas = pc._same_grid_conv(jnp.asarray(x), jnp.asarray(k), ph, pw, 4096)
    close(got, pallas, 1e-5, 'vs pallas interpret')


def test_same_grid_plain_bf16_rounds_once():
    x, k = conv_inputs(CONV_GEOMS[1], seed=1)
    xb, kb = torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16()
    got = same_grid_conv(xb, kb, 1, 1)
    assert got.dtype == torch.bfloat16
    want = same_grid_conv_plain(xb.float(), kb.float(), 1, 1).bfloat16()
    close(got.float(), want.float(), 0)


@pytest.mark.parametrize('case', [
    dict(L=4, N=32, K=16, C=10, ref_mode=True),
    dict(L=8, N=16, K=8, C=3, ref_mode=False),
    dict(L=3, N=137, K=16, C=37, ref_mode=True),
    dict(L=1, N=8, K=4, C=2, ref_mode=True),
])
def test_iws_plain_matches_jax(case, fresh_counters):
    rng = np.random.default_rng(0)
    L, N, K, C = case['L'], case['N'], case['K'], case['C']
    args = (rng.normal(size=(L, N, K)).astype(np.float32),
            rng.normal(size=(L, N)).astype(np.float32) * 5,
            rng.normal(size=(C, K)).astype(np.float32) * 2,
            rng.uniform(0.5, 2.0, size=(C,)).astype(np.float32),
            rng.normal(size=(C,)).astype(np.float32))
    got = iws_combine(*(torch.from_numpy(a) for a in args),
                      ref_mode=case['ref_mode'])
    assert tuple(got.shape) == (C, N)
    jargs = [jnp.asarray(a) for a in args]
    close(got, iws_reference_combine(*jargs, ref_mode=case['ref_mode']),
          1e-4, 'vs XLA combine')
    kw = dict(block_c=16, block_n=128) if C == 37 else {}
    close(got, iws_fused(*jargs, ref_mode=case['ref_mode'], interpret=True,
                         **kw), 1e-4, 'vs pallas interpret')


@pytest.mark.parametrize('ref_mode', [True, False])
def test_iws_plain_sum_term_matches_jax(ref_mode, fresh_counters):
    """Log weights that spread over l: the sum term carries the result, and
    it is held elementwise far below its least value (1/L)."""
    args = iws_inputs(L=16, N=32, C=10, K=32)
    got = iws_combine(*(torch.from_numpy(a) for a in args), ref_mode=ref_mode)
    jargs = [jnp.asarray(a) for a in args]
    for want, what in (
            (iws_reference_combine(*jargs, ref_mode=ref_mode), 'XLA combine'),
            (iws_fused(*jargs, ref_mode=ref_mode, interpret=True),
             'pallas interpret')):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-4, err_msg=what)


@pytest.mark.parametrize('ref_mode', [True, False])
@pytest.mark.parametrize('case', IWS_CASES, ids=iws_case_id)
def test_iws_cases_match_jax(case, ref_mode, fresh_counters):
    """Elementwise, |got - want| <= 1e-4 + 1e-6 |want| against the XLA
    combine, which sums (z - m)^2 directly as the plain version does.
    ``iws_fused`` takes the zz - 2 zm + mm expansion, whose float32
    cancellation costs up to ~2^-23 of 0.5 s2 (|z|^2 + |m|^2) per term
    and per rounding; it is held to that scale, 2^-20 of it, on top
    (about 0.08 at the prior scale 17, below 1e-5 at scale 0.1)."""
    args = iws_case_inputs(case)
    z, _, mean, s2, _ = args
    got = iws_combine(*(torch.from_numpy(a) for a in args), ref_mode=ref_mode)
    assert tuple(got.shape) == (case['C'], case['N'])
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(iws_reference_combine(*jargs, ref_mode=ref_mode))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4,
                               err_msg='vs XLA combine')
    cancel = 2.0 ** -20 * 0.5 * float(s2.max()) * float(
        np.square(z).sum(-1).max() + np.square(mean).sum(-1).max())
    fused = np.asarray(iws_fused(*jargs, ref_mode=ref_mode, interpret=True))
    np.testing.assert_allclose(got.numpy(), fused, rtol=1e-6,
                               atol=1e-4 + cancel, err_msg='vs pallas interpret')


def test_wrappers_reject_bad_input(fresh_counters):
    x = torch.zeros(2, 4, 4, 3)
    with pytest.raises(ValueError):
        same_grid_conv(x, torch.zeros(3, 3, 4, 2), 1, 1)     # channel mismatch
    with pytest.raises(ValueError):
        same_grid_conv(x, torch.zeros(3, 3, 3, 2), 3, 1)     # pad breaks grid
    with pytest.raises(ValueError):
        same_grid_conv(x[0], torch.zeros(3, 3, 3, 2), 1, 1)  # not NHWC
    z = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError):
        iws_combine(z, torch.zeros(2, 5), torch.zeros(3, 4), torch.zeros(3),
                    torch.zeros(4))                           # ldp (4,) != (3,)
    with pytest.raises(ValueError):
        iws_combine(z, torch.zeros(2, 5), torch.zeros(3, 5), torch.zeros(3),
                    torch.zeros(3))                           # mean K != z K
    with pytest.raises(ValueError):
        iws_combine(z[0], torch.zeros(2, 5), torch.zeros(3, 4),
                    torch.zeros(3), torch.zeros(3))           # z not (L,N,K)
