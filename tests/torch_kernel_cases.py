"""Kernel test cases shared by the port's CPU tests (against the JAX
package) and its card tests.  Imports neither jax nor the JAX package."""

import numpy as np

CONV_GEOMS = [
    # (n, h, w, ci, co, th, tw, ph_lo, pw_lo)
    (2, 8, 8, 3, 8, 5, 5, 2, 2),       # features conv_0 ('same' k5)
    (4, 4, 4, 8, 8, 3, 3, 1, 1),       # decoder stride-1 deconv
    (4, 8, 8, 8, 3, 5, 5, 2, 2),       # 3-channel output head
    (2, 8, 8, 4, 4, 3, 3, 0, 2),       # asymmetric pads
    (2, 6, 8, 4, 5, 3, 4, 2, 0),       # asymmetric, non-square taps
    (4, 8, 8, 64, 256, 3, 3, 1, 1),    # sub-pixel deconv, packed: two 128 tiles
    (2, 16, 16, 64, 128, 3, 3, 1, 1),  # sub-pixel deconv, packed co 128
    (2, 16, 16, 32, 128, 3, 3, 1, 1),  # the flagship's packed deconv_4
    (2, 8, 8, 3, 17, 5, 5, 2, 2),      # ci, co off the tensor-core K, N steps
    (2, 8, 8, 17, 5, 3, 3, 1, 1),      # ci off the K step, co < 8
    (3, 5, 7, 8, 16, 3, 3, 1, 1),      # M tail: 105 pixels in 7-wide rows
]
WIDE_CONV_GEOM = (3, 40, 70, 17, 40, 3, 3, 1, 1)   # several column tiles


def conv_inputs(geom, seed=0):
    n, h, w, ci, co, th, tw, _, _ = geom
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((th, tw, ci, co)) * 0.1).astype(np.float32)
    return x, k


def iws_inputs(L, N, C, K, seed=0):
    """IWAE-combine inputs (z, log_pxq, mean, s2, log_det_prior) whose log
    weights spread by a few units over l, so that the sum term (mean-exp
    or log-mean-exp), and not the max alone, carries the result."""
    rng = np.random.default_rng(seed)
    mean = 0.1 * rng.standard_normal((C, K))
    y = rng.integers(0, C, N)
    z = mean[y][None] + 0.3 * rng.standard_normal((L, N, K))
    lp = -1e3 + rng.standard_normal((L, N))
    vp = rng.uniform(0.5, 1.5, C)
    return tuple(a.astype(np.float32) for a in
                 (z, lp, mean, vp * vp, -2.0 * K * np.log(vp)))
