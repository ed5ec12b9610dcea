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

# Geometries that stress the tensor-core kernel's tiling (wgmma N tiles of
# 8..128, 128-pixel M tiles, 64-byte channel chunks, taps folded into K
# where ci fits in 16 bytes) and the float32 co < 8 kernel.
STRESS_CONV_GEOMS = [
    (3, 8, 8, 3, 3, 5, 5, 2, 2),       # ci 3 folded, co 3
    (5, 8, 8, 8, 8, 3, 3, 1, 1),       # ci 8, co 8; M 320: a 64-row tail
    (3, 8, 8, 17, 32, 5, 5, 2, 2),     # ci 17: a partial chunk
    (5, 8, 8, 64, 64, 5, 5, 2, 2),     # two 8x8 images a tile, M tail
    (3, 8, 8, 64, 256, 3, 3, 1, 1),    # co 256: two N tiles of 128
    (2, 9, 11, 64, 32, 3, 5, 0, 4),    # asymmetric pads, 3x5 taps
    (2, 5, 13, 8, 64, 5, 3, 4, 0),     # asymmetric, M 130
    (1, 3, 3, 3, 8, 5, 5, 1, 3),       # an image smaller than the taps
    (4, 7, 9, 3, 17, 5, 5, 2, 2),      # folded, co 17 (N tile 32)
    (2, 4, 4, 64, 3, 3, 3, 1, 1),      # co 3 at ci 64
    (2, 12, 40, 17, 7, 5, 5, 2, 2),    # co 7, 40 wide: two column tiles
    (2, 6, 6, 5, 5, 1, 1, 0, 0),       # 1x1 taps: one unit a chunk
    (2, 8, 8, 3, 32, 7, 7, 3, 3),      # folded, 49 taps: a ragged unit
    (2, 9, 9, 2, 100, 5, 5, 2, 2),     # co 100 in a 128 tile
]

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
# all eight same-grid sites of the flagship's forward
FLAGSHIP_SITE_GEOMS = {'features_stack.conv_0': (8, 32, 32, 3, 32, 5, 5, 2, 2),
                       **FLAGSHIP_DX_GEOMS}

# four of imagenet64's eighteen same-grid sites (models/cvnet.py::
# imagenet64_config), as launched, at a small batch: the 64x64 grid of
# vgg16's conv_1; a 4x4 grid at ci 512 (K = 4,608), where a 128-row tile
# spans 8 images; the k=4, s=2 sub-pixel deconv_1's packed kernel (3x3
# taps to 4 x 256 channels); the 5x5 head at 64x64.  Each takes an input
# gradient in a train step.
IMAGENET64_SITE_GEOMS = {
    'features_stack.conv_1': (4, 64, 64, 64, 64, 3, 3, 1, 1),
    'features_stack.conv_15': (16, 4, 4, 512, 512, 3, 3, 1, 1),
    'imager.deconv_1': (16, 4, 4, 512, 1024, 3, 3, 1, 1),   # sub-pixel, packed
    'imager.conv_5': (4, 64, 64, 32, 3, 5, 5, 2, 2),
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
    # the streamed kernel (K > 352): the first K the resident one cannot
    # hold (ragged, K % 4 != 0), [fashion]'s and [fashion-vgg16]'s K at the
    # prior scale 17, one k in the last chunk of 128
    dict(L=4, N=17, C=5, K=353, mean_scale=0.1),
    dict(L=8, N=24, C=10, K=512, mean_scale=17.0),
    dict(L=4, N=16, C=3, K=1024, mean_scale=17.0),
    dict(L=3, N=17, C=4, K=1025, mean_scale=0.1),
]


def iws_case_id(case):
    return 'L{L}-N{N}-C{C}-K{K}-m{mean_scale:g}'.format(**case)


def iws_case_inputs(case, seed=0):
    return iws_inputs(case['L'], case['N'], case['C'], case['K'], seed=seed,
                      mean_scale=case['mean_scale'])
