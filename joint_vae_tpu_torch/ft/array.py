"""WIM/FT job arrays: aggregate many same-config fine-tuning jobs.

Port of ``joint_vae_tpu/ft/array.py`` (ref ``ft/array.py:18-251``): an array directory holds a ``jobs``
registry file; member jobs' recorders (including the pre-tuning ``init``
records) are merged along the sample axis into array-level recorders, and
the OOD rates are recomputed on the union — more samples, tighter rates.
The rates are computed on the host from the record files: no model runs.
"""

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.roc import DEFAULT_KEPT_TPR, two_sided_from_method
from ..save_load.checkpoint import save_json
from ..save_load.recorders import (LossRecorder, find_record,
                                    record_filename)
from .job import host_roc, wim_scores_for_set
from .wim import WIM_OOD_METHODS_PER_TYPE, WIMJob


class WIMArray:
    def __init__(self, array_dir: str):
        self.dir = array_dir
        os.makedirs(array_dir, exist_ok=True)
        self.jobs_file = os.path.join(array_dir, 'jobs')
        self.ood_results: Dict = {}

    # -- registry (ref ft/array.py:95-110) --------------------------------

    def registered_jobs(self) -> List[str]:
        if not os.path.exists(self.jobs_file):
            return []
        with open(self.jobs_file) as f:
            return [l.strip() for l in f if l.strip()]

    def register_jobs(self, *job_dirs: str) -> List[str]:
        jobs = self.registered_jobs()
        for d in job_dirs:
            d = os.path.abspath(d)
            if d not in jobs:
                jobs.append(d)
        with open(self.jobs_file, 'w') as f:
            f.write('\n'.join(jobs) + '\n')
        return jobs

    # -- recorder merge (ref ft/array.py:111-210) --------------------------

    def _last_sample_dir(self, job_dir: str) -> Optional[str]:
        samples = os.path.join(job_dir, 'samples')
        if not os.path.isdir(samples):
            return None
        epochs = sorted(d for d in os.listdir(samples) if d.isdigit())
        return os.path.join(samples, epochs[-1]) if epochs else None

    def merge_recorders(self, set_name: str, init: bool = False
                        ) -> Optional[LossRecorder]:
        recs = []
        for jd in self.registered_jobs():
            sd = self._last_sample_dir(jd)
            if sd is None:
                continue
            if init:
                sd = os.path.join(sd, 'init')
            p = find_record(sd, set_name)
            if p is not None:
                recs.append(LossRecorder.load(p))
        if not recs:
            return None
        merged = recs[0] if len(recs) == 1 else recs[0].merge(*recs[1:])
        out = os.path.join(self.dir, 'samples', 'array',
                           ('pre-' if init else '')
                           + record_filename(set_name))
        merged.save(out)
        return merged

    def recompute_rates(self, wim: WIMJob, testset_name: str,
                        ood_names: Sequence[str],
                        methods: Optional[Sequence[str]] = None) -> Dict:
        """ROC on the merged (union) recorders (ref WIMArray, ft/array.py:251)."""
        cfg = wim.cfg
        methods = list(methods or WIM_OOD_METHODS_PER_TYPE.get(
            cfg.type, ['elbo', 'zdist']))
        ind_rec = self.merge_recorders(testset_name)
        if ind_rec is None:
            logging.warning('no recorders for %s in array', testset_name)
            return {}
        ind_losses = {k: ind_rec.get(k) for k in ind_rec.keys()}
        if 'logits' in ind_losses:
            ind_losses['logits'] = ind_losses['logits'].T
        ind_scores = wim_scores_for_set(wim, ind_losses, methods)

        results: Dict = {}
        for s in ood_names:
            rec = self.merge_recorders(s)
            if rec is None:
                continue
            losses = {k: rec.get(k) for k in rec.keys()}
            if 'logits' in losses:
                losses['logits'] = losses['logits'].T
            scores = wim_scores_for_set(wim, losses, methods)
            results[s] = {}
            for m in methods:
                r = host_roc(ind_scores[m], scores[m], two_sided_from_method(m))
                results[s][m] = {
                    # 'n' counts OOD samples everywhere (engines.py json
                    # tier compares it against the oodset size)
                    'n': int(np.asarray(scores[m]).shape[0]),
                    'auc': float(r['auc']),
                    'tpr': [float(t) for t in DEFAULT_KEPT_TPR],
                    'fpr': r['fpr'].tolist(),
                    'mean': float(np.mean(scores[m])),
                    'std': float(np.std(scores[m]))}
        self.ood_results = results
        save_json(results, os.path.join(self.dir, 'ood.json'))
        return results


FTArray = WIMArray
