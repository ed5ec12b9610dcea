"""The numbers that decide ``correct``: what the program produced against
what the plain reference works out again from the same inputs.

Scoring (per scored batch, the worst over the batches compared), one
number, ``answer_gap``: the widest relative gap of any answer the scorer
gives for an image, the largest of

- each method's score: |program - reference| over the larger of
  |reference| and the batch's median |reference| of that method (for
  ``soft``, its log over the top class's |KL|: ``_domain``);
- the classifier's confidence, the same way;
- the label: how far below the reference's best class the program's
  label lies in the reference's IWAE estimate, over |the best|;
- the accept bit: where it differs, how near the reference's score of a
  method whose test differs lies to its bound (as the score's gap
  measures), the nearest such method; infinite where no method's test
  differs (the program's gate is wrong).

The confidence is what lower precision moves: the scores average the
decoder's outputs over every pixel and sample, and move by float32's own
rounding either way (PERF.md).

Training (the window's own call of the trainer: its steps up to its
first pull, 8 on the card), each leaf's norm against the reference's,
the gap over the larger of the reference leaf's norm and the median
leaf's:

- ``loss_gap``: the mean loss of the steps up to the first pull, as the
  trainer pulls and reports it there, relative;
- ``grad_gap``: the first step's gradient as Adam takes it (its first
  moment after one step over 1 - b1), the worst leaf; ``grad_median``
  the same, the median leaf (TF32 moves every leaf a little, a sound run
  moves a few leaves near a ReLU's or a max-pool's tie: PERF.md);
- ``update_gap``: the weights' change over the compared steps (3), the
  median leaf: a leaf's change under Adam counts the elements that moved,
  and an element whose gradient is zero but for rounding moves by a full
  step on one side and not at all on the other (PERF.md), so the worst
  leaf reads the last conv block's dead units and not the step.

Leaves whose first reference gradient is under a thousandth of the
median leaf's are left out of ``grad_gap`` and ``update_gap``: Adam moves
such a leaf by its rounding alone.
"""

import math
from typing import Dict

import numpy as np
import torch

SMALL_LEAF = 1e-3
COMPARED_STEPS = 3      # the weights are compared after this step


def thresholds_from(scores: Dict[str, np.ndarray]) -> dict:
    """Each method's accept bound from a calibration batch's scores: its
    5% quantile, or its 5% and 95% ones for a two-sided ('-2s') method."""
    return {m: ((float(np.quantile(v, 0.05)), float(np.quantile(v, 0.95)))
                if m.endswith('-2s') else float(np.quantile(v, 0.05)))
            for m, v in scores.items()}


def bounds(t):
    """(low, high) of a method's accept bound: one-sided or a pair."""
    return (float(t[0]), float(t[1])) if isinstance(t, (tuple, list)) \
        else (float(t), math.inf)


def _domain(method: str, want: dict):
    """How a method's score is compared: a map of its values and the scale
    of each image's gap.  ``soft`` (the top class's softmax of -KL) is
    compared by its log over the top class's |KL|: where two classes' KLs
    nearly tie, float32's rounding of KLs of some 1e4 moves the softmax by
    1e-4 of itself, and its log by that rounding alone."""
    base = method[:-3] if method.endswith('-2s') else method
    r = want['scores'][method].double().cpu().numpy()
    if base == 'soft':
        kl = np.abs(want['kl_top'].double().cpu().numpy())
        with np.errstate(divide='ignore'):
            return np.log, np.log(r), np.maximum(kl, np.median(kl))
    return (lambda v: v), r, np.maximum(np.abs(r), np.median(np.abs(r)))


def score_gaps(got: dict, want: dict, thresholds: dict) -> Dict[str, float]:
    """The scoring numbers of one batch: ``got`` as the Scorer returns it
    (host arrays), ``want`` as ``reference/model.py::score_batch``.  Each
    method's own gap is given too, under ``gap.<method>``."""
    out = {}
    dom = {m: _domain(m, want) for m in want['scores']}
    for m, (f, r, s) in dom.items():
        p = f(np.asarray(got['scores'][m], np.float64))
        out['gap.' + m] = float(np.max(np.abs(p - r) / s))
    out['score_gap'] = max(out.values())
    c = want['confidence'].double().cpu().numpy()
    out['conf_gap'] = float(np.max(
        np.abs(np.asarray(got['confidence'], np.float64) - c)
        / np.maximum(np.abs(c), np.median(np.abs(c)))))
    iws = want['iws'].double().cpu().numpy()             # (C, N)
    cols = np.arange(iws.shape[1])
    best = iws[want['label'].cpu().numpy(), cols]
    mine = iws[np.asarray(got['label']), cols]
    out['label_gap'] = float(np.max((best - mine) / np.abs(best)))
    # the accept bits
    r_in = np.ones(iws.shape[1], bool)
    tests = {}
    for m, t in thresholds.items():
        lo, hi = bounds(t)
        f, r, s = dom[m]
        rv = want['scores'][m].double().cpu().numpy()
        p = np.asarray(got['scores'][m], np.float64)
        with np.errstate(divide='ignore', invalid='ignore'):
            near = np.minimum(np.abs(r - f(lo)), np.abs(r - f(hi))) / s
        tests[m] = ((rv >= lo) & (rv <= hi), (p >= lo) & (p <= hi), near)
        r_in &= tests[m][0]
    differ = np.nonzero(r_in != np.asarray(got['in_distribution'], bool))[0]
    gap = 0.0
    for i in differ:
        near = [tests[m][2][i] for m in tests if tests[m][0][i] != tests[m][1][i]]
        gap = max(gap, min(near) if near else math.inf)
    out['accept_gap'] = float(gap)
    out['answer_gap'] = max(out['score_gap'], out['conf_gap'],
                            out['label_gap'], out['accept_gap'])
    return out


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """Each kept leaf's |‖got‖ - ‖want‖| over the larger of ‖want‖ and the
    median kept leaf's ‖want‖."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double()))
             for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.vector_norm(got[k].double()))
                   - norms[k]) / max(norms[k], med) for k in keep}


def kept_leaves(first_grad: Dict[str, torch.Tensor]) -> list:
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in first_grad.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= SMALL_LEAF * med]


def train_gaps(got: dict, want: dict, initial: Dict[str, torch.Tensor],
               leaves: Dict[str, dict] = None) -> Dict[str, float]:
    """``got`` as ``entries/train.py`` records the program (loss: the mean
    over the steps up to the first pull; first_grad; after: the weights
    after the compared steps; host tensors), ``want`` as
    ``reference/steps.py::adam_steps`` over the same steps; ``initial``
    the weights both started from.  ``leaves`` takes each leaf's gaps."""
    ref_loss = float(np.mean(want['losses']))
    loss = abs(got['loss'] - ref_loss) / abs(ref_loss)
    wg = {k: v.detach().cpu() for k, v in want['first_grad'].items()}
    keep = kept_leaves(wg)
    grad = leaf_gaps({k: got['first_grad'][k] for k in keep}, wg, keep)
    d_got = {k: got['after'][k].double() - initial[k].detach().cpu().double()
             for k in keep}
    d_want = {k: want['after'][k].detach().cpu().double()
              - initial[k].detach().cpu().double() for k in keep}
    update = leaf_gaps(d_got, d_want, keep)
    if leaves is not None:
        leaves.update(grad=grad, update=update)
    return {'loss_gap': float(loss), 'grad_gap': max(grad.values()),
            'grad_median': float(np.median(list(grad.values()))),
            'update_gap': float(np.median(list(update.values())))}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {'value', 'limit'}} and whether every value is within its
    limit (a NaN never is)."""
    checks = {k: {'value': float(values[k]), 'limit': float(limits[k])}
              for k in limits}
    ok = all(c['value'] <= c['limit'] for c in checks.values())
    return checks, ok
