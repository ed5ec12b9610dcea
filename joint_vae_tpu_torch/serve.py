"""Serving: the classify + OOD-gate scorer over a trained job.

Port of ``joint_vae_tpu/serve.py``.  Per batch it runs the label-free
evaluation (``models/evaluate.py``), the OOD scores and label prediction
(``ops/scores.py``), and applies accept thresholds calibrated from the
job's stored ood_results (FPR@TPR operating points, ood.json schema).
It runs on the device the job was loaded on (``load_job(..., device)``).

The counterpart of the JAX Scorer's ``jax.jit run`` is a CUDA graph
(``train/graphs.py::ScoreGraph``), one per batch shape (and so per
Scorer's L): the batch goes to the card from pinned memory, and every
output comes back to the host in one pull.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import set_float32_math
from .models.evaluate import evaluate
from .ops.scores import batch_dist_measures, predict_after_evaluate
from .save_load.jobs import Job
from .train.graphs import ScoreGraph


def _generator(device: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass
class Scorer:
    """Inference head over a trained job.

    methods: OOD score methods to emit; thresholds: {method: low or (low,
    up)} accept bounds (score >= low means in-distribution), by default
    calibrated from the newest ood_results entry at the requested TPR.
    ``graphed`` (default) scores each batch as a CUDA graph on the card
    (the first batch of a shape eager, the second captured); False runs
    the same body eagerly, the reference a graph is held to."""
    job: Job
    predict_method: str = 'default'
    methods: Sequence[str] = ('elbo',)
    thresholds: Optional[Dict[str, float]] = None
    tpr: float = 0.95
    L: Optional[int] = None
    graphed: bool = True

    def __post_init__(self):
        set_float32_math()
        self.methods = tuple(self.methods)
        if self.thresholds is None:
            self.thresholds = calibrated_thresholds(self.job, self.methods,
                                                    self.tpr)
        cfg = self.job.model_cfg
        self._pm = (self.predict_method if self.predict_method != 'default'
                    else (cfg.predict_methods[0] if cfg.predict_methods
                          else 'esty'))

        def _pair(v):
            if isinstance(v, (tuple, list)):
                return float(v[0]), float(v[1])
            return float(v), float('inf')

        self._bounds = {m: _pair(self.thresholds.get(m, float('-inf')))
                        for m in self.methods}
        # the default noise: seed 0, reseeded before every call
        self._generator = _generator(self.job.device)
        self.graph = ScoreGraph(self._score, name='scorer',
                                graphed=self.graphed)

    def _score(self, generator: Optional[torch.Generator], x: torch.Tensor,
               eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One batch, its outputs packed as the rows of one float64 tensor
        (label, confidence, each method's score, in_distribution), which
        holds each of them exactly."""
        job = self.job
        cfg = job.model_cfg
        with torch.no_grad():
            out = evaluate(job.model, x, None, sigma_state=job.sigma_state,
                           L=self.L, decode_mean=False, eps=eps,
                           generator=generator)
            scores = batch_dist_measures(cfg, out.logits, out.losses,
                                         self.methods)
            logits = out.logits
            if logits.ndim == 3 and self._pm == 'esty':
                # y-coded types carry a leading class-hypothesis axis
                logits = torch.mean(logits, dim=0)
            label = predict_after_evaluate(cfg, logits, out.losses, self._pm)
            if logits.ndim == 3:
                # per-item logits = the row at each predicted hypothesis
                logits = torch.gather(
                    logits, 0, label[None, :, None].expand(
                        (1,) + logits.shape[1:]))[0]
            conf = torch.amax(torch.softmax(logits, dim=-1), dim=-1)
            in_dist = torch.ones(x.shape[0], dtype=torch.bool,
                                 device=x.device)
            for m in self.methods:
                lo, hi = self._bounds[m]
                in_dist &= (scores[m] >= lo) & (scores[m] <= hi)
            # a bfloat16 model's confidence and logit scores come out as
            # float32, which holds them exactly (numpy has no bfloat16)
            rows = ([label, conf.float()]
                    + [scores[m].float() for m in self.methods] + [in_dist])
            return {'packed': torch.stack([r.double() for r in rows])}

    def __call__(self, x: np.ndarray, *, eps: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, np.ndarray]:
        """Score a batch x (N, *input_shape).  The latent noise comes from
        ``eps`` (L+1, N, K) or ``generator`` (default: seed 0 on the job's
        device, the same noise every call); a graph is captured anew for a
        caller's own generator."""
        dev = self.job.device
        if generator is None:
            generator = self._generator.manual_seed(0)
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if dev.type == 'cuda':
            xt = xt.pin_memory()
        job = self.job
        out = self.graph(generator, x=xt.to(dev, non_blocking=True), eps=eps,
                         owner=(job.model, job.sigma_state.data,
                                job.sigma_state.rmse))
        host = out['packed'].cpu().numpy()
        k = len(self.methods)
        return {'label': host[0].astype(np.int64),
                'confidence': host[1].astype(np.float32),
                'scores': {m: host[2 + i].astype(np.float32)
                           for i, m in enumerate(self.methods)},
                'in_distribution': host[2 + k].astype(bool)}


def predict(job: Job, x: np.ndarray, method: str = 'default', *,
            eps: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> np.ndarray:
    """One-shot prediction (ref CVNet.predict, cvae.py:919-936)."""
    set_float32_math()
    dev = job.device
    if eps is None and generator is None:
        generator = _generator(dev)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    out = evaluate(job.model, xt, None, sigma_state=job.sigma_state,
                   eps=eps, generator=generator)
    return predict_after_evaluate(job.model_cfg, out.logits, out.losses,
                                  method).cpu().numpy()


def calibrated_thresholds(job: Job, methods: Sequence[str],
                          tpr: float = 0.95) -> Dict[str, Tuple[float, float]]:
    """Accept thresholds at the requested kept-TPR from stored ood_results
    (lowest threshold over OOD sets = most permissive consistent gate)."""
    out: Dict[str, Tuple[float, float]] = {}
    epochs = sorted((e for e in job.ood_results if isinstance(e, int)),
                    reverse=True)
    for m in methods:
        found: List[float] = []
        found_up: List[float] = []
        for e in epochs:
            for s, ms in job.ood_results[e].items():
                r = ms.get(m)
                if not isinstance(r, dict) or not r.get('thresholds'):
                    continue
                tprs = r.get('tpr') or []
                idx = [i for i, t in enumerate(tprs) if abs(t - tpr) < 1e-6]
                if idx:
                    thr = float(r['thresholds'][idx[0]])
                    if not np.isfinite(thr):
                        # a degenerate ROC carries no gating information
                        continue
                    found.append(thr)
                    ups = r.get('thresholds_up')
                    found_up.append(float(ups[idx[0]]) if ups
                                    else float('inf'))
            if found:
                break
        out[m] = ((min(found), max(found_up)) if found
                  else (float('-inf'), float('inf')))
    return out
