"""The port's ROC (``ops/roc.py``) against the JAX package's, on seeded
numpy scores: the three test geometries, both score orientations, ties,
and the validation split with JAX's permutation injected.  Rates, AUC,
precision, mean and std within 1e-6; thresholds equal.

The 'around-mean' center is a float32 mean whose rounding depends on the
summation order (XLA's and the port's float64-then-round differ by an ulp
on general scores, and a threshold ``center - |s - center|`` then lands on
the other side of ``s``).  Its cases use dyadic scores (multiples of 1/8)
over power-of-two counts, whose mean every order computes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joint_vae_tpu.ops import roc as jroc

from joint_vae_tpu_torch.ops import roc as troc

TOL = 1e-6
N_IN, N_OUT = 1024, 700
GEOMETRIES = [False, 'around-mean', (1, 1), (4, 1), (3, 2)]


def _scores(seed, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:
        ins = rng.integers(-40, 60, N_IN) / 8
        outs = rng.integers(-60, 40, N_OUT) / 8
    else:
        ins = rng.normal(0.5, 1.0, N_IN)
        outs = rng.normal(0.0, 1.5, N_OUT)
        # ties within and across the two sets
        ins[:100] = np.round(ins[:100], 1)
        outs[:100] = np.round(outs[:100], 1)
    return ins.astype(np.float32), outs.astype(np.float32)


def _compare(j, t):
    for k in ('auc', 'fpr', 'tpr', 'precision', 'mean', 'std'):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    for k in ('thresholds_low', 'thresholds_up'):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)
    assert int(t['n']) == int(j['n'])


# every geometry both ways without a split; the split (a count, then a
# fraction) for the two-sided ones, where it applies
CASES = ([(g, hi, 0) for g in GEOMETRIES for hi in (True, False)]
         + [(g, True, 256) for g in GEOMETRIES[1:]]
         + [('around-mean', False, 0.125), ((3, 2), False, 0.125)])


@pytest.mark.parametrize('geometry,ins_are_higher,validation', CASES, ids=str)
def test_roc_curve_matches_jax(geometry, ins_are_higher, validation):
    ins, outs = _scores(1, dyadic=geometry == 'around-mean')
    key = jax.random.key(3)
    perm = np.array(jax.random.permutation(key, N_IN))
    j = jroc.roc_curve(jnp.asarray(ins), jnp.asarray(outs),
                       two_sided=geometry, validation=validation,
                       ins_are_higher=ins_are_higher, key=key)
    t = troc.roc_curve(torch.from_numpy(ins), torch.from_numpy(outs),
                       two_sided=geometry, validation=validation,
                       ins_are_higher=ins_are_higher,
                       perm=torch.from_numpy(perm))
    _compare(j, t)


def test_degenerate_and_helpers_match_jax():
    ins, outs = _scores(2, dyadic=False)
    # all outs above all ins: no kept point reaches a tpr, the defaults hold
    j = jroc.roc_curve(jnp.asarray(ins), jnp.asarray(outs + 100.0))
    t = troc.roc_curve(torch.from_numpy(ins), torch.from_numpy(outs + 100.0))
    _compare(j, t)
    fpr, tpr = t['fpr'], t['tpr']
    for a in (0.9, 0.95):
        assert float(troc.fpr_at_tpr(fpr, tpr, a)) == float(
            jroc.fpr_at_tpr(np.asarray(fpr), np.asarray(tpr), a))
        assert float(troc.tpr_at_fpr(fpr, tpr, a)) == float(
            jroc.tpr_at_fpr(np.asarray(fpr), np.asarray(tpr), a))
    np.testing.assert_allclose(
        float(troc.auroc_one_sided_exact(torch.from_numpy(ins),
                                         torch.from_numpy(outs))),
        float(jroc.auroc_one_sided_exact(jnp.asarray(ins), jnp.asarray(outs))),
        rtol=TOL)
    for m in ('iws', 'elbo-2s', 'iws-a-4-1', 'soft', 'mse-a-1-1'):
        assert troc.two_sided_from_method(m) == jroc.two_sided_from_method(m)


def test_validation_split_draws_from_generator():
    ins, outs = _scores(3, dyadic=True)
    a, b = (troc.roc_curve(torch.from_numpy(ins), torch.from_numpy(outs),
                           two_sided=(4, 1), validation=256,
                           generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    np.testing.assert_array_equal(a['fpr'].numpy(), b['fpr'].numpy())
