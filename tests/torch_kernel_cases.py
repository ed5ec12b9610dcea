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

# The forward geometries (n, h, w, ci, co, th, tw, ph_lo, pw_lo) of the
# flagship's seven same-grid sites whose input gradient a train step
# launches (features conv_0 reads the data and has none); dx swaps ci and
# co: conv_6's is 3 -> 32, the sub-pixel ones 256 -> 64 and 128 -> 32.
FLAGSHIP_DX_GEOMS = {
    'features_stack.conv_2': (8, 16, 16, 32, 64, 5, 5, 2, 2),
    'imager.deconv_1': (8, 8, 8, 64, 64, 5, 5, 2, 2),
    'imager.deconv_2': (8, 8, 8, 64, 256, 3, 3, 1, 1),     # sub-pixel, packed
    'imager.deconv_3': (8, 16, 16, 64, 32, 5, 5, 2, 2),
    'imager.deconv_4': (8, 16, 16, 32, 128, 3, 3, 1, 1),   # sub-pixel, packed
    'imager.deconv_5': (8, 32, 32, 32, 32, 5, 5, 2, 2),
    'imager.conv_6': (8, 32, 32, 32, 3, 5, 5, 2, 2),
}


def conv_inputs(geom, seed=0):
    n, h, w, ci, co, th, tw, _, _ = geom
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((th, tw, ci, co)) * 0.1).astype(np.float32)
    return x, k


def iws_inputs(L, N, C, K, seed=0, mean_scale=0.1):
    """IWAE-combine inputs (z, log_pxq, mean, s2, log_det_prior) whose log
    weights spread by a few units over l, so that the sum term (mean-exp
    or log-mean-exp), and not the max alone, carries the result: z within
    0.3 of its class mean per latent, log_pxq of unit noise about -1e3.
    ``mean_scale`` 17 draws the means as the flagship's prior does
    (``init_mean=17``, so |m|^2 ~ 289 K), where the true class's term is
    a small difference of large norms."""
    rng = np.random.default_rng(seed)
    mean = mean_scale * rng.standard_normal((C, K))
    y = rng.integers(0, C, N)
    z = mean[y][None] + 0.3 * rng.standard_normal((L, N, K))
    lp = -1e3 + rng.standard_normal((L, N))
    vp = rng.uniform(0.5, 1.5, C)
    return tuple(a.astype(np.float32) for a in
                 (z, lp, mean, vp * vp, -2.0 * K * np.log(vp)))


# IWAE-combine cases (L, N, C, K, mean scale), shared by the CPU tests
# against the JAX package and the card tests against the plain version
IWS_CASES = [
    dict(L=16, N=32, C=100, K=128, mean_scale=17.0),   # the flagship's prior scale
    dict(L=1, N=17, C=10, K=32, mean_scale=0.1),
    dict(L=3, N=17, C=10, K=32, mean_scale=0.1),
    dict(L=128, N=17, C=10, K=32, mean_scale=0.1),     # the reference's eval L
    dict(L=8, N=33, C=12, K=20, mean_scale=0.1),       # K % 4 != 0
    dict(L=8, N=40, C=1, K=16, mean_scale=0.1),
    dict(L=4, N=24, C=40, K=256, mean_scale=0.1),      # the imagenet64 K
]


def iws_case_id(case):
    return 'L{L}-N{N}-C{C}-K{K}-m{mean_scale:g}'.format(**case)


def iws_case_inputs(case, seed=0):
    return iws_inputs(case['L'], case['N'], case['C'], case['K'], seed=seed,
                      mean_scale=case['mean_scale'])
