"""ROC / AUROC / FPR@TPR with one-sided and two-sided tests, on the device
the scores lie on.

Port of ``joint_vae_tpu/ops/roc.py`` (ref ``utils/roc_curves.py:38-210``):
sorts and ``torch.searchsorted`` over the whole score vectors, no host
loop.  Test geometries (selected by method suffix, ref cvae.py:1849-1855):

- one-sided:      in-distribution iff score >= t           (plain methods)
- 'around-mean':  iff |score - center| <= delta            (suffix ``-2s``)
- (p, q) tuple:   iff t_low <= score <= t_up where the lower threshold walks
  the sorted in-scores p times faster than the upper walks down (suffix
  ``-a-p-q``)

Semantics, as in the JAX package: thresholds are the sorted in-scores
themselves; kept FPR@TPR is the smallest fpr whose tpr still reaches the
target; AUROC is the trapezoid over the swept (fpr, tpr) points with (0, 0)
appended; counts and rates are float32.  The 'around-mean' center is the
mean of the validation split of the in-scores (all of them by default),
taken in float64 and rounded to float32 so that it does not depend on the
device's reduction order.

The validation split is a random permutation: the JAX package draws it
with ``jax.random.permutation``, which torch cannot reproduce, so here it
comes from ``perm`` when given, else from ``generator`` (default: a CPU
generator seeded 0).
"""

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

DEFAULT_KEPT_TPR = tuple(t / 100 for t in range(90, 100))

TwoSided = Union[bool, str, Tuple[int, int]]

_INF = float('inf')


def fpr_at_tpr(fpr: torch.Tensor, tpr: torch.Tensor, a: float,
               thresholds: Optional[torch.Tensor] = None,
               return_threshold: bool = False):
    """First fpr (ascending-tpr order) with tpr >= a (ref roc_curves.py:8-27)."""
    big = torch.where(tpr >= a, fpr, torch.full_like(fpr, _INF))
    i = torch.argmin(big)
    if return_threshold:
        return fpr[i], thresholds[i]
    return fpr[i]


def tpr_at_fpr(fpr: torch.Tensor, tpr: torch.Tensor, a: float) -> torch.Tensor:
    """Max tpr among points with fpr <= a (ref roc_curves.py:30-35)."""
    return torch.max(torch.where(fpr <= a, tpr, torch.full_like(tpr, -_INF)))


def _rate(count: torch.Tensor, n: int) -> torch.Tensor:
    """count / n in float32, correctly rounded (as jnp divides int32
    counts with x64 off).  The divisor is a tensor on the counts' device:
    divided by a Python number, the CUDA kernel multiplies by its
    reciprocal, one ulp off at times, which moves a rate across a kept
    TPR."""
    return count.to(torch.float32) / torch.full(
        (), float(n), dtype=torch.float32, device=count.device)


def _sweep(sorted_ins, sorted_outs, lows, ups):
    """tpr/fpr for interval tests [low_t, up_t] (vectorized over t)."""
    def negatives(s):
        below = torch.searchsorted(s, lows, right=False)
        above = s.shape[0] - torch.searchsorted(s, ups, right=True)
        return below + above
    tpr = 1.0 - _rate(negatives(sorted_ins), sorted_ins.shape[0])
    fpr = 1.0 - _rate(negatives(sorted_outs), sorted_outs.shape[0])
    return tpr, fpr


def _auc_trapz(fpr, tpr, valid):
    """Trapezoid over swept points (fpr descending in t) + final (0, 0),
    masking invalid (crossed-threshold) iterations."""
    zero = torch.zeros(1, dtype=fpr.dtype, device=fpr.device)
    f = torch.cat([torch.where(valid, fpr, 0.0), zero])
    t = torch.cat([torch.where(valid, tpr, 0.0), zero])
    return torch.sum((f[:-1] - f[1:]) * (t[:-1] + t[1:]) * 0.5)


def _kept_at_tpr(tpr, fpr, lows, ups, kept_tpr, valid):
    """Per kept-tpr target: the point with smallest fpr whose tpr >= target."""
    kept = torch.tensor(list(kept_tpr), dtype=torch.float32, device=tpr.device)
    ok = (tpr[None, :] >= kept[:, None]) & valid[None, :]
    masked = torch.where(ok, fpr[None, :], _INF)
    idx = torch.argmin(masked, dim=1)
    any_ok = torch.any(ok, dim=1)
    kf = torch.where(any_ok, fpr[idx], 1.0)
    kt = torch.where(any_ok, tpr[idx], 1.0)
    kl = torch.where(any_ok, lows[idx], -_INF)
    ku = torch.where(any_ok, ups[idx], _INF)
    return kf, kt, kl, ku


def _interp(x: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, arange(len(fp)), fp)``: linear interpolation on unit
    knots, clamped to the end values.  The last step ``fp[i-1] + t * df``
    is taken in float64 and rounded once, as the fused multiply-add that
    XLA emits for it."""
    n = fp.shape[0]
    xp = torch.arange(n, dtype=torch.float32, device=fp.device)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    t = (x - xp[i - 1]) / (xp[i] - xp[i - 1])
    f = (fp[i - 1].double() + t.double() * (fp[i] - fp[i - 1]).double()).float()
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _linspace_to(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` in float32 as XLA folds it:
    ``i * (stop / (num - 1))``, the last point ``stop``."""
    delta = (torch.tensor(stop, dtype=torch.float32)
             / torch.tensor(num - 1, dtype=torch.float32)).item()
    head = torch.arange(num - 1, dtype=torch.float32, device=device) * delta
    last = torch.full((1,), stop, dtype=torch.float32, device=device)
    return torch.cat([head, last])


def _with(head: float, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.full((1,), head, dtype=t.dtype, device=t.device), t])


def roc_curve(ins: torch.Tensor, outs: torch.Tensor,
              kept_tpr: Sequence[float] = DEFAULT_KEPT_TPR,
              two_sided: TwoSided = False,
              validation: Union[int, float] = 0,
              ins_are_higher: bool = True,
              perm: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
    """AUROC + FPR/thresholds at kept TPRs, on the scores' device.

    ``validation`` (two-sided tests only, ref roc_curves.py:49-64): a count
    (or fraction) of in-scores set aside by a random permutation split
    (``perm``, else drawn from ``generator``); the 'around-mean' center
    (resp. the ``-a-p-q`` threshold base) comes from the held-out subset
    while the sweep and TPR counting use the remaining ins.

    Returns a dict of tensors: auc (), fpr (K,), tpr (K,),
    thresholds_low/up (K,), precision (K,), mean, std and n.
    """
    sign = 1.0 if ins_are_higher else -1.0
    ins = sign * ins.reshape(-1).to(torch.float32)
    outs = sign * outs.reshape(-1).to(torch.float32)
    dev = ins.device
    n_total = ins.shape[0]
    mean_all = torch.mean(sign * ins)
    std_all = torch.std(ins, correction=0)

    if two_sided and validation:
        if validation < 1:
            validation = int(validation * n_total)
        validation = int(validation)
        if validation <= 0 or validation >= n_total:
            # a fraction that floors to zero (or swallows everything)
            # degenerates to validating on all ins (ref roc_curves.py:59-64)
            validation = 0
            val_scores = ins
        else:
            if perm is None:
                if generator is None:
                    generator = torch.Generator().manual_seed(0)
                perm = torch.randperm(n_total, generator=generator,
                                      device=generator.device)
            perm = perm.to(dev)
            val_scores = ins[perm[:validation]]
            ins = ins[perm[validation:]]
    else:
        validation = 0
        val_scores = ins

    n_in = ins.shape[0]
    sorted_ins = torch.sort(ins).values
    sorted_outs = torch.sort(outs).values

    if two_sided == 'around-mean':
        center = torch.mean(val_scores.double()).float()
        deltas = torch.sort(torch.abs(ins - center)).values.flip(0)
        lows = _with(-_INF, center - deltas)
        ups = _with(_INF, center + deltas)
        valid = lows < ups
    elif isinstance(two_sided, tuple):
        p, q = two_sided
        if validation:
            # upsample the sorted validation scores back to n_total points
            # before striding (ref fits a cubic spline, roc_curves.py:76-83;
            # linear interpolation here, as in the JAX package)
            sv = torch.sort(val_scores).values
            base = _interp(_linspace_to(validation - 1.0, n_total, dev), sv)
        else:
            base = sorted_ins
        lo_seq = base[::p]
        up_seq = base[::q]
        nt = min(lo_seq.shape[0], up_seq.shape[0]) + 1
        lows = _with(-_INF, lo_seq)[:nt]
        ups = _with(_INF, up_seq.flip(0))[:nt]
        valid = lows < ups
    else:
        lows = _with(-_INF, sorted_ins)
        ups = torch.full_like(lows, _INF)
        valid = torch.ones((n_in + 1,), dtype=torch.bool, device=dev)

    tpr, fpr = _sweep(sorted_ins, sorted_outs, lows, ups)
    auc = _auc_trapz(fpr, tpr, valid)
    kf, kt, kl, ku = _kept_at_tpr(tpr, fpr, lows, ups, kept_tpr, valid)

    n_out = outs.shape[0]
    precision = kt * n_in / torch.clamp(kt * n_in + kf * n_out, min=1e-30)

    # undo the sign flip on thresholds (ref lowup mapping, roc_curves.py:41)
    if not ins_are_higher:
        kl, ku = -ku, -kl
    return {'auc': auc, 'fpr': kf, 'tpr': kt,
            'thresholds_low': kl, 'thresholds_up': ku,
            'precision': precision,
            'mean': mean_all, 'std': std_all,
            'n': torch.tensor(n_total, device=dev)}


def two_sided_from_method(method: str) -> TwoSided:
    """Method-suffix grammar -> test geometry (ref cvae.py:1849-1855)."""
    if method.endswith('-2s'):
        return 'around-mean'
    if '-a-' in method:
        parts = method.split('-')
        return (int(parts[-2]), int(parts[-1]))
    return False


def auroc_one_sided_exact(ins: torch.Tensor, outs: torch.Tensor) -> torch.Tensor:
    """Exact rank-statistic AUROC (Mann-Whitney U with tie correction);
    equals the swept trapezoid for continuous scores."""
    ins = ins.reshape(-1).to(torch.float32)
    outs = outs.reshape(-1).to(torch.float32)
    sorted_outs = torch.sort(outs).values
    below = torch.searchsorted(sorted_outs, ins, right=False)
    ties = torch.searchsorted(sorted_outs, ins, right=True) - below
    return torch.sum(below + 0.5 * ties) / (ins.shape[0] * outs.shape[0])
