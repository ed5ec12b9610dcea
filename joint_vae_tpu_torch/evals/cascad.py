"""Cascaded models: feed model i+1 with the reconstruction of model i
(ref module/cascad.py:15-197 + results/cascad.py).

Port of ``joint_vae_tpu/evals/cascad.py``.  Produces per-stage losses,
the cross-stage reconstruction MSE matrix Im(T), and Bayes-iterated
posteriors (ref iterate_with_prior).  Stage i draws its latent noise from
its own generator, seeded ``fold_in(seed, i)`` (JAX folds the stage into
its key)."""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import to_device
from ..models.evaluate import evaluate
from ..save_load.jobs import Job
from ..train.state import fold_in, make_generator


class CascadModels:
    def __init__(self, *jobs: Job):
        if not jobs:
            raise ValueError('no jobs to cascade')
        if len({j.model_cfg.input_shape for j in jobs}) != 1:
            raise ValueError('cascaded models need one input shape')
        self.jobs = list(jobs)

    def evaluate(self, x: np.ndarray, seed: int = 0):
        """-> (stage_losses: list of dicts, stage_recos: (S+1, N, ...),
        mse_matrix: (S+1, S+1), posteriors: per stage (C, N) or None)."""
        recos = [np.asarray(x, np.float32)]
        stage_losses: List[Dict[str, np.ndarray]] = []
        posteriors: List[Optional[np.ndarray]] = []
        cur = None
        for i, job in enumerate(self.jobs):
            dev = job.device
            cur = to_device(np.asarray(x), dev) if cur is None else cur.to(dev)
            out = evaluate(job.model, cur, None, sigma_state=job.sigma_state,
                           train=False,
                           generator=make_generator(dev, fold_in(seed, i)))
            x_reco = out.x_reco.float()
            if job.model_cfg.output_distribution == 'categorical':
                x_reco = torch.argmax(x_reco, dim=-4) / 255.0
            cur = x_reco[0]                      # mean reconstruction
            recos.append(cur.cpu().numpy())
            stage_losses.append({k: v.cpu().numpy()
                                 for k, v in out.losses.items()})
            posteriors.append(torch.softmax(out.logits.float(), dim=-1)
                              .cpu().numpy().T
                              if out.logits.ndim == 2 else None)

        S = len(recos)
        mse = np.zeros((S, S))
        flat = [r.reshape(r.shape[0], -1) for r in recos]
        for i in range(S):
            for j in range(S):
                mse[i, j] = float(np.mean((flat[i] - flat[j]) ** 2))
        return stage_losses, np.stack(recos), mse, posteriors


def iterate_with_prior(posteriors: Sequence[np.ndarray],
                       prior: Optional[np.ndarray] = None) -> np.ndarray:
    """Bayes-chain posteriors p_i(y|x) (C, N) with a prior
    (ref cascad.py iterate_with_prior): p ~ prior * prod_i p_i / prior^(S-1)
    normalized per item."""
    ps = [np.asarray(p, np.float64) for p in posteriors if p is not None]
    if not ps:
        raise ValueError('no posterior to iterate')
    C = ps[0].shape[0]
    prior = (np.ones(C) / C if prior is None
             else np.asarray(prior, np.float64))
    log_p = np.log(prior)[:, None] * (1 - len(ps))
    for p in ps:
        log_p = log_p + np.log(np.maximum(p, 1e-30))
    log_p -= log_p.max(0, keepdims=True)
    e = np.exp(log_p)
    return e / e.sum(0, keepdims=True)
