"""Multi-model ensembling (ref module/aggregation.py:8-111 +
results/aggregation.py).

Port of ``joint_vae_tpu/evals/aggregation.py``.  Posterior combination
over a list of per-class score arrays (C, N), numpy in float64:

- 'dist'/'joint': sum of zdists -> softmax(-sum/2)  (joint gaussian view)
- 'elbo'/'lme':   log-mean-exp of per-model log-evidences
- 'mean':         mean of per-model softmax posteriors
- 'vote':         majority vote over per-model argmax predictions

Plus the latent mutual information between two models' p(y|z)
(ref compute_latent_mutual_info), whose per-sample tensors run
``evaluate`` and the prior's log density on the jobs' device.
"""

from typing import Sequence

import numpy as np
import torch

from ..device import to_device
from ..models.evaluate import evaluate
from ..ops.priors import prior_log_density
from ..train.state import fold_in, make_generator
from ..utils.mutual_information import mutual_information


def _softmax(a, axis=0):
    a = np.asarray(a, np.float64)
    a = a - a.max(axis=axis, keepdims=True)
    e = np.exp(a)
    return e / e.sum(axis=axis, keepdims=True)


def ensemble_posterior(scores: Sequence[np.ndarray], method: str = 'elbo'
                       ) -> np.ndarray:
    """scores: per model, (C, N) log-evidence-like (higher = more likely);
    for 'dist'/'joint' pass zdist (lower = closer).  -> posterior (C, N)."""
    s = np.stack([np.asarray(x, np.float64) for x in scores])  # (M, C, N)
    if method in ('dist', 'joint'):
        return _softmax(-0.5 * s.sum(0), axis=0)
    if method in ('elbo', 'lme', 'iws'):
        m = s.max(axis=0)
        lme = np.log(np.mean(np.exp(s - m), axis=0)) + m
        return _softmax(lme, axis=0)
    if method in ('mean', 'mean~'):
        # 'mean~' is the same combine on different inputs: the reference
        # feeds softmax(-kl) per model where 'mean' feeds softmax(iws)
        # (ref results/aggregation.py:18 agg_type_letter, :330-335)
        return np.mean([_softmax(x, axis=0) for x in s], axis=0)
    if method == 'vote':
        C, N = s.shape[1:]
        votes = np.zeros((C, N))
        for x in s:
            votes[x.argmax(0), np.arange(N)] += 1
        return votes / len(s)
    raise ValueError(method)


def ensemble_predict(scores: Sequence[np.ndarray], method: str = 'elbo'
                     ) -> np.ndarray:
    return ensemble_posterior(scores, method).argmax(0)


def latent_mutual_info_tensors(job1, job2, x, temps=(1.0, 2.0, 5.0),
                               seed: int = 0):
    """Per-sample latent agreement Im(T) between two conditional jobs
    (ref latent_mutual_info, module/aggregation.py:70-111): each model's
    latent samples z_l score every class through its prior log-density,
    p_i(y|z;T) = softmax_C(log p(z|y)/T), and
    Im(T)[n] = E_{l1,l2}[log sum_y p_1(y|z_l1;T) p_2(y|z_l2;T)] — the log
    probability both posteriors agree on a label.  Job i draws its noise
    from ``fold_in(seed, i)``.

    -> ({T: (N,) float32}, y_ ensemble prediction of model 1).
    """
    log_ps = []
    y_ = None
    for i, job in enumerate((job1, job2)):
        dev = job.device
        out = evaluate(job.model, to_device(np.asarray(x), dev), None,
                       sigma_state=job.sigma_state, train=False,
                       decode_mean=False,
                       generator=make_generator(dev, fold_in(seed, i)))
        z1 = out.z[1:].float()                        # (L, N, K)
        with torch.no_grad():
            lp = prior_log_density(job.model_cfg.prior, job.model.prior(),
                                   z1, all_classes=True)  # (C, L, N)
        lp = torch.movedim(lp, 0, 1)                  # (L, C, N)
        log_ps.append(lp.to(log_ps[0].device) if log_ps else lp)
        if i == 0:
            y_ = torch.argmax(torch.mean(lp, dim=0), dim=0).cpu().numpy()
    Im = {}
    for T in temps:
        p1 = torch.softmax(log_ps[0] / T, dim=1)
        p2 = torch.softmax(log_ps[1] / T, dim=1)
        agree = torch.einsum('acn,bcn->abn', p1, p2)  # (L1, L2, N)
        Im[T] = torch.mean(torch.log(torch.clamp(agree, min=1e-30)),
                           dim=(0, 1)).cpu().numpy().astype(np.float32)
    return Im, y_


def compute_latent_mutual_info(p1: np.ndarray, p2: np.ndarray) -> float:
    """I between two models' label posteriors p(y|z) of shape (C, N):
    joint = E_n[p1(:, n) outer p2(:, n)] (ref aggregation.py:60-111)."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    p1 = p1 / np.maximum(p1.sum(0, keepdims=True), 1e-12)
    p2 = p2 / np.maximum(p2.sum(0, keepdims=True), 1e-12)
    joint = np.einsum('cn,dn->cd', p1, p2) / p1.shape[1]
    return mutual_information(joint)
