"""The same-grid conv kernel's order of work, emulated on the CPU.

``csrc/same_grid_conv.cu`` feeds wgmma A from registers and B (the
weights) from shared memory.  Its K dimension runs over units of 64 bytes
of channels of one tap (or, for ci of at most 16 bytes, four taps of 16
bytes each: the taps folded into K); inside a unit the channels are
ordered so that each thread's 16-byte shared load is its A fragment of
two wgmma K steps, and the weights are staged in the same order (K-major
for TF32, the weights' own N-major rows for bf16, read transposed).
In float32 each iteration's products go into a fresh partial sum of
3xTF32 products that is added to the total once the iteration is done.

These tests hold that design before any card runs it:

- the channel a thread's A fragment holds equals the channel the B tile
  holds at every K position of every step (both dtypes);
- the conv summed in the kernel's K order (units, chunks, folded taps,
  zero padding) equals the JAX package's conv on the same numpy inputs;
- the kernel's float32 arithmetic (TF32 split, products summed by the
  tensor core with every term truncated to the largest one's 24 bits and
  the sum truncated into the partial, a fresh partial per iteration added
  with rounding to nearest) stays within the card tests' 1e-5 gate of the
  float64 conv at the flagship's widest K (64 channels, 5x5 taps), where
  one running sum over K does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch

import joint_vae_tpu.ops.pallas_conv as pc

from joint_vae_tpu_torch.ops.same_grid_conv import kernel_route, wgmma_tile

from torch_kernel_cases import (CONV_GEOMS, FLAGSHIP_DX_GEOMS,
                                STRESS_CONV_GEOMS, conv_inputs)

DTYPES = ('float32', 'bfloat16')
EPU = {'float32': 4, 'bfloat16': 8}       # elements in 16 bytes
KS = {'float32': 8, 'bfloat16': 16}       # K of one wgmma (k8 tf32, k16 bf16)


def channel_of(kq, i, dt):
    """The unit's channel at row ``kq`` of the B core matrices, element
    ``i`` of that 16-byte row (the kernel's ``channel_of``)."""
    return 4 * i + kq if dt == 'float32' else 8 * (i >> 1) + 2 * kq + (i & 1)


def b_channel(s, k, dt):
    """The unit's channel at K position k of wgmma step s in the B tile."""
    kl = KS[dt] * s + k
    return channel_of(kl // EPU[dt], kl % EPU[dt], dt)


def a_channel(s, k, dt):
    """The unit's channel that A's register fragment holds at K position k
    of step s: the thread holding column k loads bytes [16t, 16t+16) of
    the staged pixel, channels EPU*t.. (m16n8k8 / m16n8k16 layouts)."""
    if dt == 'float32':            # a0/a1: k = t, a2/a3: k = t + 4
        t, hi = k % 4, k // 4
        return 4 * t + 2 * s + hi
    t, e, hi = (k % 8) // 2, k % 2, k // 8   # pairs (2t, 2t+1), (2t+8, ..)
    return 8 * t + 2 * (2 * s + hi) + e


def k_order(ci, th, tw, co, dt):
    """The kernel's K order: a list of iterations, each a list of wgmma
    steps, each a (tap, channel) pair per K position (-1 where padded)."""
    e = EPU[dt]
    taps = th * tw
    route = kernel_route(getattr(torch, dt), ci, co)
    fold = ci <= e
    if route['kernel'] == 'wgmma':
        assert route['folded'] == fold
    ku = 4 * e
    nchunks = 1 if fold else -(-ci // ku)
    units = -(-taps // 4) if fold else taps
    u_it = wgmma_tile(getattr(torch, dt), co)['units']
    order = []
    for chunk in range(nchunks):
        for u0 in range(0, units, u_it):
            it = []
            for unit in range(u0, min(units, u0 + u_it)):
                for s in range(2):
                    step = []
                    for k in range(KS[dt]):
                        q = b_channel(s, k, dt)
                        tap = unit * 4 + q // e if fold else unit
                        c = q % e if fold else chunk * ku + q
                        ok = tap < taps and c < ci
                        step.append((tap, c) if ok else (-1, -1))
                    it.append(step)
            order.append(it)
    return order


def shifted(x, ph, pw, th, tw):
    """x_pad windows: (th*tw, n, h, w, ci), tap (a, b) at index a*tw + b."""
    n, h, w, _ = x.shape
    xp = np.pad(x, ((0, 0), (ph, th - 1 - ph), (pw, tw - 1 - pw), (0, 0)))
    return np.stack([xp[:, a:a + h, b:b + w] for a in range(th)
                     for b in range(tw)])


@pytest.mark.parametrize('dt', DTYPES)
def test_a_fragment_channels_match_b_tile(dt):
    for s in range(2):
        for k in range(KS[dt]):
            assert a_channel(s, k, dt) == b_channel(s, k, dt), (s, k)
    # a unit's 4 x EPU channels, each once
    got = sorted(b_channel(s, k, dt) for s in range(2) for k in range(KS[dt]))
    assert got == list(range(4 * EPU[dt]))


@pytest.mark.parametrize('dt', DTYPES)
@pytest.mark.parametrize('geom', CONV_GEOMS + STRESS_CONV_GEOMS)
def test_k_order_sums_to_the_jax_conv(geom, dt):
    n, h, w, ci, co, th, tw, ph, pw = geom
    x, k = conv_inputs(geom, seed=3)
    order = k_order(ci, th, tw, co, dt)
    seen = [pair for it in order for step in it for pair in step
            if pair[0] >= 0]
    assert sorted(seen) == [(t, c) for t in range(th * tw) for c in range(ci)]
    xs = shifted(x.astype(np.float64), ph, pw, th, tw)
    kf = k.astype(np.float64).reshape(th * tw, ci, co)
    y = np.zeros((n, h, w, co))
    for it in order:
        for step in it:
            for tap, c in step:
                if tap >= 0:
                    y += xs[tap, ..., c, None] * kf[tap, c]
    want = pc._xla_conv(jnp.asarray(x), jnp.asarray(k), ph, th - 1 - ph,
                        pw, tw - 1 - pw)
    np.testing.assert_allclose(y, np.asarray(want), rtol=1e-5, atol=1e-5)


def tf32_split(v):
    """(big, small) of float32 v as the kernel splits it."""
    u = v.astype(np.float32).view(np.uint32)
    big = ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
    small = ((v.astype(np.float32) - big).view(np.uint32)
             & np.uint32(0xffffe000)).view(np.float32)
    return big.astype(np.float64), small.astype(np.float64)


def to_f32_rz(v):
    """float64 -> float32, rounded toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r.astype(np.float64)


def tc_add(acc, terms):
    """acc + sum(terms) as the tensor core is modelled: every addend
    truncated to 24 bits at the largest one's exponent, summed, the sum
    truncated to float32."""
    stack = np.stack([acc] + terms)
    big = np.max(np.abs(stack), axis=0)
    _, ex = np.frexp(np.where(big > 0, big, 1.0))
    ulp = np.ldexp(1.0, ex - 24)
    return to_f32_rz(np.sum(np.trunc(stack / ulp) * ulp, axis=0))


def emulate_f32(xs, kf, order, fresh_partial=True):
    """The float32 kernel's arithmetic over ``order``: 3xTF32 per wgmma
    step (small*big, big*small, big*big), each through :func:`tc_add`."""
    xb, xsml = tf32_split(xs)
    kb, ksml = tf32_split(kf)
    acc = np.zeros(xs.shape[1:2] + kf.shape[2:])
    part = np.zeros_like(acc)
    for it in order:
        for step in it:
            idx = [(t, c) for t, c in step if t >= 0]
            for a, b in ((xsml, kb), (xb, ksml), (xb, kb)):
                part = tc_add(part, [a[t, :, c, None] * b[t, c]
                                     for t, c in idx])
        if fresh_partial:
            acc = (acc.astype(np.float32) + part.astype(np.float32)).astype(
                np.float64)
            part = np.zeros_like(acc)
    return acc if fresh_partial else part


@pytest.mark.parametrize('site', ['imager.deconv_1', 'imager.deconv_2'])
def test_f32_arithmetic_within_the_gate_at_the_widest_k(site):
    """deconv_1: ci=64 at 5x5 (K=1,600, the flagship's widest); deconv_2
    packed: ci=64 at 3x3 to co=256, where a kernel without fresh partial
    sums put 98 elements past the gate on the card."""
    n, h, w, ci, co, th, tw, ph, pw = FLAGSHIP_DX_GEOMS[site]
    x, k = conv_inputs((1, h, w, ci, co, th, tw, ph, pw), seed=5)
    co = min(co, 16)                      # 16 output channels suffice
    k = np.ascontiguousarray(k[..., :co])
    xs = shifted(x.astype(np.float64), ph, pw, th, tw)
    xs = xs.reshape(th * tw, h * w, ci)
    kf = k.astype(np.float64).reshape(th * tw, ci, co)
    want = np.einsum('tpc,tco->po', xs, kf)
    order = k_order(ci, th, tw, FLAGSHIP_DX_GEOMS[site][4], 'float32')
    got = emulate_f32(xs, kf, order)
    err = np.abs(got - want)
    assert np.all(err <= 1e-5 + 1e-5 * np.abs(want)), err.max()
    assert err.max() > 0                  # the model does truncate
    one_sum = np.abs(emulate_f32(xs, kf, order, fresh_partial=False) - want)
    assert one_sum.max() > err.max()
    if site == 'imager.deconv_1':
        assert not np.all(one_sum <= 1e-5 + 1e-5 * np.abs(want))
