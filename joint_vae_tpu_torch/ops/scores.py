"""OOD / misclassification score measures and label prediction.

Port of ``joint_vae_tpu/ops/scores.py`` (ref cvae.py:938-1085).  Given the
per-item losses of :func:`models.evaluate.evaluate` (per-class (C, N),
per-input (N,)) and the sample-averaged logits, one score per input and
method; higher means more in-distribution.  The ROC suffixes '-2s' and
'-a-p-q' are stripped here (they change the test, not the measure).
The WIM variants ('k~', 'k@', 'k~@', 'softk~') score from the recorded
alternate-prior loss twins and estimated labels (``ft/wim.py``).
"""

import math
from typing import Dict, List, Sequence

import torch

from ..models.cvnet import CVNetConfig, METHODS_PARAMS


def develop_starred_methods(methods: Sequence[str],
                            methods_params: Dict[str, List[str]] = None,
                            add_starred: bool = False) -> List[str]:
    """'odin*' -> the full ODIN parameter grid, etc."""
    methods_params = methods_params or METHODS_PARAMS
    out = []
    for m in methods:
        if m.endswith('*'):
            out.extend(methods_params.get(m[:-1], []))
            if add_starred:
                out.append(m)
        else:
            out.append(m)
    return out


def strip_roc_suffix(method: str) -> str:
    if method.endswith('-2s'):
        return method[:-3]
    if '-a-' in method:
        return method.split('-a-')[0]
    return method


def _std(x: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.std default: Bessel-corrected (ddof=1), ref cvae.py:1056."""
    return torch.std(x, dim=dim, correction=1)


def batch_dist_measures(cfg: CVNetConfig, logits: torch.Tensor,
                        losses: Dict[str, torch.Tensor],
                        methods: Sequence[str]) -> Dict[str, torch.Tensor]:
    """Scores per method; each output is (N,) float32."""
    C = cfg.num_labels
    per_class = cfg.losses_per_class

    logp = -losses['total'].float()
    if per_class:
        logp_max = torch.amax(logp, dim=0)
        d_logp = logp - logp_max[None]
    else:
        logp_max = logp
        d_logp = torch.zeros_like(logp)

    iws = losses.get('iws')
    if iws is None and any('iws' in m for m in methods):
        iws = -losses['total']     # ref fallback (cvae.py:992-994)
    if iws is not None and per_class:
        iws_max = torch.amax(iws, dim=0)
        d_iws = iws - iws_max[None]

    out: Dict[str, torch.Tensor] = {}
    for m_full in methods:
        m = strip_roc_suffix(m_full)
        if m and m[-1] in '~@':
            # WIM variants score from the recorded loss twins and estimated
            # labels; reachable when replaying a WIM job's record files
            from ..ft.wim import wim_measures
            y_est = losses.get('y_est_already')
            if y_est is not None:
                y_est = y_est.long()
            out[m_full] = wim_measures(cfg, losses, [m],
                                       y_est=y_est)[m].float()
            continue
        if m == 'elbo':
            v = logp_max if per_class else logp
        elif m == 'iws':
            if per_class:
                v = torch.log(torch.sum(torch.exp(d_iws), dim=0)) + iws_max
                if not cfg.is_jvae:
                    v = v + math.log(C)
            else:
                v = iws
        elif m == 'sum':
            v = torch.log(torch.sum(torch.exp(d_logp), dim=0)) + logp_max
        elif m == 'max':
            v = logp_max
        elif m == 'softiws':
            v = torch.amax(torch.softmax(iws, dim=0), dim=0)
        elif m.startswith('softiws-'):
            T = float(m[8:])
            # sign quirk kept from ref cvae.py:1028: -iws/T for the T grid
            v = torch.amax(torch.softmax(-iws / T, dim=0), dim=0)
        elif m in ('soft', 'softkl'):
            v = torch.amax(torch.softmax(-losses['kl'], dim=0), dim=0)
        elif m.startswith('softkl-'):
            T = float(m[7:])
            v = torch.amax(torch.softmax(-losses['kl'] / T, dim=0), dim=0)
        elif m in ('zdist', 'kl', 'fisher_rao', 'mahala', 'kl_rec'):
            v = -losses[m] if cfg.is_vae else torch.amax(-losses[m], dim=0)
        elif m.startswith('soft') and '-' in m:
            T = float(m.split('-')[-1])
            k = m.split('-')[0][4:]
            v = torch.amax(torch.softmax(-losses[k] / T, dim=0), dim=0)
        elif m == 'logits':
            v = torch.amax(logits, dim=-1)
        elif m.startswith('baseline'):
            T = float(m.split('-')[-1]) if '-' in m else 1.0
            v = torch.amax(torch.softmax(logits / T, dim=-1), dim=-1)
        elif m == 'mag':
            # torch.median semantics: the LOWER middle element for even C
            v = logp_max - torch.sort(logp, dim=0).values[(logp.shape[0] - 1) // 2]
        elif m == 'std':
            v = _std(logp, 0)
        elif m == 'mean':
            v = torch.log(torch.mean(torch.exp(d_logp), dim=0)) + logp_max
        elif m == 'nstd':
            e = torch.exp(d_logp)
            v = torch.square(torch.exp(torch.log(_std(e, 0))
                                       - torch.log(torch.mean(e, dim=0))))
        elif m == 'hyz':
            p = torch.softmax(logits, dim=-1)
            v = torch.sum(p * torch.log(torch.clamp(p, min=1e-30)), dim=-1)
        elif m == 'IYx':
            e = torch.exp(d_logp)
            d_logp_x = torch.log(torch.mean(e, dim=0))
            v = (torch.sum(d_logp * e, dim=0) / (C * torch.exp(d_logp_x))
                 - d_logp_x)
        elif m == 'mse' and cfg.is_cvae:
            v = -losses['cross_x']
        elif m == 'wmse' and cfg.is_cvae:
            v = -losses['wmse']
        elif m.startswith('odin'):
            v = losses[m]            # precomputed by the ODIN grid pass
        else:
            raise ValueError('unknown method {}'.format(m_full))
        out[m_full] = v.float()
    return out


def predict_after_evaluate(cfg: CVNetConfig, logits: torch.Tensor,
                           losses: Dict[str, torch.Tensor],
                           method: str = 'default') -> torch.Tensor:
    """Label prediction from eval outputs (ref cvae.py:938-970)."""
    if method == 'default':
        method = cfg.predict_methods[0]
    if method is None:
        return torch.softmax(logits, dim=-1)
    if method == 'mean':
        return torch.argmax(torch.mean(torch.softmax(logits, dim=-1), dim=0),
                            dim=-1)
    if method == 'loss':
        return torch.argmin(losses['total'], dim=0)
    if method == 'esty':
        return torch.argmax(logits, dim=-1)
    if method == 'closest':
        return torch.argmin(losses['zdist'], dim=0)
    if method == 'iws':
        return torch.argmax(losses['iws'], dim=0)
    if method == 'already':
        return losses['y_est_already']
    raise ValueError('Unknown method {}'.format(method))
