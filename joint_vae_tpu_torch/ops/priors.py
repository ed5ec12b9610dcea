"""Latent prior families: gaussian / tilted / uniform-with-gaussian-tail.

Port of ``joint_vae_tpu/ops/priors.py`` (ref ``module/priors.py``).
Prior parameters are ``{'mean': (P, K), 'var_param': ...}`` tensors; the
static structure lives in :class:`PriorConfig`.  The class-conditional case
has a ``y``-gather path (labels given) and an all-classes path used by
per-class evaluation, where the class axis is a leading broadcast dim.

Parameterization: ``var_param`` is the *inverse* scale — 1/sigma for
``scalar``/``diag``, the inverse Cholesky factor M (Sigma^-1 = M^T M) for
``full``.  KL components: ``trace`` = tr(S Sigma^-1), ``log_det`` =
sum(log_var), ``log_det_prior`` = log|Sigma|, ``distance`` = Mahalanobis,
``var_kl`` = trace - log_det + log_det_prior - K, ``kl`` = (distance +
w * var_kl) / 2.
"""

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

_LOG_2PI = math.log(2 * math.pi)


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Static prior structure."""
    dim: int
    distribution: str = 'gaussian'        # gaussian | tilted | uniform
    num_priors: int = 1                   # 1 => unconditional
    var_dim: str = 'scalar'               # scalar | diag | full
    init_mean: Any = 0.0                  # float | 'onehot'
    mean_shift: float = 0.0
    learned_means: bool = False
    freeze_means: int = 0
    force_conditional: bool = False
    tau: float = 0.0                      # tilted: ~25; uniform: ~5
    seed: Optional[int] = None

    def __post_init__(self):
        if self.distribution not in ('gaussian', 'tilted', 'uniform'):
            raise ValueError(self.distribution)
        if self.var_dim not in ('scalar', 'diag', 'full'):
            raise ValueError(self.var_dim)
        if self.distribution in ('tilted', 'uniform'):
            object.__setattr__(self, 'var_dim', 'scalar')
        if self.num_priors == 1:
            object.__setattr__(self, 'learned_means', False)
        if self.distribution == 'tilted' and not self.tau:
            object.__setattr__(self, 'tau', 25.0)
        if self.distribution == 'uniform' and not self.tau:
            object.__setattr__(self, 'tau', 5.0)

    @property
    def conditional(self) -> bool:
        return self.num_priors > 1 or self.force_conditional

    @property
    def learned_var(self) -> bool:
        return self.var_dim != 'scalar'

    @property
    def params(self) -> Dict[str, Any]:
        """JSON summary (ref ``Prior.params``)."""
        d = {'distribution': self.distribution, 'dim': self.dim,
             'init_mean': self.init_mean, 'var_dim': self.var_dim,
             'num_priors': self.num_priors}
        if self.conditional:
            d.update({'learned_means': self.learned_means,
                      'freeze_means': self.freeze_means})
        if self.distribution in ('tilted', 'uniform'):
            d['tau'] = self.tau
            d.pop('var_dim', None)
        return d

    @property
    def uniform_log_rho(self) -> float:
        """log rho(z) on [-tau, tau] for the uniform family."""
        tau = self.tau
        phi_tau = 0.5 * (1.0 + math.erf(tau / math.sqrt(2.0)))
        return math.log(2 * tau) - math.log(2 * phi_tau - 1)

    @property
    def var_param_shape(self):
        v = {'scalar': (), 'diag': (self.dim,),
             'full': (self.dim, self.dim)}[self.var_dim]
        return ((self.num_priors,) + v) if self.conditional else v


def build_prior_config(dim: int, distribution: str = 'gaussian', **kw) -> PriorConfig:
    """Factory mirroring ref ``build_prior``."""
    if kw.get('num_priors', 1) == 1:
        kw.pop('learned_means', None)
    kw = {k: v for k, v in kw.items() if v is not None}
    if distribution == 'gaussian':
        kw.pop('tau', None)
    return PriorConfig(dim=dim, distribution=distribution, **kw)


def init_prior_arrays(cfg: PriorConfig, rng: np.random.Generator
                      ) -> Dict[str, np.ndarray]:
    """Fresh prior parameters from a numpy generator (the reference's
    init: scaled gaussian or one-hot means, unit inverse scales)."""
    K, P = cfg.dim, cfg.num_priors
    if P > 1 and cfg.init_mean == 'onehot':
        if K < P:
            raise ValueError('K={} < C={}'.format(K, P))
        mean = np.eye(P, K)
    else:
        scale = 0.0 if cfg.init_mean == 'onehot' else float(cfg.init_mean)
        mean = scale * rng.standard_normal((P, K)) + cfg.mean_shift
    v = {'scalar': np.array(1.0), 'diag': np.ones((K,)),
         'full': np.eye(K)}[cfg.var_dim]
    if cfg.conditional:
        v = np.stack([v] * P)
    return {'mean': mean.astype(np.float32), 'var_param': v.astype(np.float32)}


# ---------------------------------------------------------------------------
# internals
# ---------------------------------------------------------------------------

def _inv_trans(cfg: PriorConfig, var_param: torch.Tensor) -> torch.Tensor:
    if cfg.var_dim == 'full':
        return torch.tril(var_param)
    return var_param


def log_det_per_class(cfg: PriorConfig, var_param: torch.Tensor) -> torch.Tensor:
    """log |Sigma| per class: (P,) if conditional else scalar."""
    t = _inv_trans(cfg, var_param)
    if cfg.var_dim == 'full':
        diag = torch.diagonal(t, dim1=-2, dim2=-1)
        return -2.0 * torch.sum(torch.log(torch.abs(diag)), dim=-1)
    if cfg.var_dim == 'diag':
        return -2.0 * torch.sum(torch.log(torch.abs(t)), dim=-1)
    return -2.0 * cfg.dim * torch.log(t)


def _centered(cfg: PriorConfig, params: Params, x: torch.Tensor,
              y: Optional[torch.Tensor], all_classes: bool) -> torch.Tensor:
    """x - mean_y; ``all_classes``: x (..., K) -> (P, ..., K)."""
    mean = params['mean']
    if not cfg.conditional:
        return x - mean[0]
    if all_classes:
        m = mean.reshape((cfg.num_priors,) + (1,) * (x.ndim - 1) + (cfg.dim,))
        return x[None] - m
    return x - mean[y]


def _whiten(cfg: PriorConfig, var_param: torch.Tensor, u: torch.Tensor,
            y: Optional[torch.Tensor], all_classes: bool) -> torch.Tensor:
    """Inverse-scale transform of centered latents."""
    t = _inv_trans(cfg, var_param)
    if not cfg.conditional:
        if cfg.var_dim == 'full':
            return torch.einsum('ij,...j->...i', t, u)
        return u * t
    if all_classes:
        shape = (cfg.num_priors,) + (1,) * (u.ndim - 2)
        if cfg.var_dim == 'full':
            P = cfg.num_priors
            w = torch.einsum('pij,pbj->pbi', t, u.reshape(P, -1, cfg.dim))
            return w.reshape(u.shape)
        if cfg.var_dim == 'diag':
            return u * t.reshape(shape + (cfg.dim,))
        return u * t.reshape(shape + (1,))
    ty = t[y]
    if cfg.var_dim == 'full':
        return torch.einsum('...ij,...j->...i', ty, u)
    if cfg.var_dim == 'diag':
        return u * ty
    return u * ty[..., None]


def _mahala_all_classes_matmul(cfg: PriorConfig, params: Params,
                               x: torch.Tensor) -> torch.Tensor:
    """All-classes Mahalanobis as matmuls:
    sum_k s2_ck (x_k - m_ck)^2 = x^2 @ s2_c - 2 x @ (s2_c m_c) + s2_c . m_c^2.
    Output (P, ...batch)."""
    mean = params['mean'].float()
    vp = params['var_param'].float()
    P, K = mean.shape
    if cfg.var_dim == 'scalar':
        s2_full = torch.square(vp).reshape(P, 1).expand(P, K)
    else:
        s2_full = torch.square(vp)
    quad = torch.matmul(torch.square(x), s2_full.T)
    cross = torch.matmul(x, (s2_full * mean).T)
    const = torch.sum(s2_full * torch.square(mean), dim=-1)
    out = quad - 2.0 * cross + const
    return torch.movedim(out, -1, 0)


def _mahala(cfg: PriorConfig, params: Params, x: torch.Tensor,
            y: Optional[torch.Tensor], all_classes: bool) -> torch.Tensor:
    x = x.float()
    if all_classes and cfg.conditional and cfg.var_dim in ('scalar', 'diag'):
        return _mahala_all_classes_matmul(cfg, params, x)
    u = _centered(cfg, params, x, y, all_classes)
    w = _whiten(cfg, params['var_param'], u, y, all_classes)
    return torch.sum(torch.square(w), dim=-1)


def _prior_inv_var_diag(cfg: PriorConfig, var_param: torch.Tensor) -> torch.Tensor:
    """diag(Sigma^-1) per class."""
    t = _inv_trans(cfg, var_param)
    if cfg.var_dim == 'full':
        return torch.sum(torch.square(t), dim=-2)
    return torch.square(t)


def mahala(cfg: PriorConfig, params: Params, x: torch.Tensor,
           y: Optional[torch.Tensor] = None, all_classes: bool = False) -> torch.Tensor:
    """Mahalanobis distance to the prior mean(s)."""
    return _mahala(cfg, params, x, y, all_classes)


# ---------------------------------------------------------------------------
# public: KL and log density
# ---------------------------------------------------------------------------

def prior_kl(cfg: PriorConfig, params: Params, mu: torch.Tensor,
             log_var: torch.Tensor, y: Optional[torch.Tensor] = None,
             var_weighting: float = 1.0,
             all_classes: bool = False) -> Dict[str, torch.Tensor]:
    """KL(q(z|x) || p(z|y)) in components; ``all_classes`` gives every
    output a leading class axis (P, ...)."""
    mu = mu.float()
    log_var = log_var.float()
    if cfg.distribution == 'gaussian':
        return _gaussian_kl(cfg, params, mu, log_var, y, var_weighting, all_classes)
    if cfg.distribution == 'tilted':
        return _tilted_kl(cfg, params, mu, y, all_classes)
    return _uniform_kl(cfg, params, mu, log_var, y, var_weighting, all_classes)


def _gaussian_kl(cfg, params, mu, log_var, y, var_weighting, all_classes):
    # var_kl = trace - log det + log det prior - K is a difference of sums
    # of K terms near 1: summed in float32, their rounding (an ulp of K,
    # 1.22e-4 at K=1024) would be most of it and differ between devices,
    # so the sums run in float64 and var_kl is rounded once
    dt = log_var.dtype
    log_var = log_var.double()
    var = torch.exp(log_var)
    var_param = params['var_param'].double()
    inv_var_diag = _prior_inv_var_diag(cfg, var_param)
    ldp = log_det_per_class(cfg, var_param)
    P, K = cfg.num_priors, cfg.dim

    if cfg.conditional:
        if all_classes:
            shape = (P,) + (1,) * (mu.ndim - 1)
            if cfg.var_dim == 'scalar':
                ivd_full = inv_var_diag.reshape(P, 1).expand(P, K)
            else:
                ivd_full = inv_var_diag
            trace = torch.movedim(torch.matmul(var, ivd_full.T), -1, 0)
            log_det_prior = ldp.reshape(shape).expand((P,) + mu.shape[:-1])
            log_det = torch.sum(log_var, dim=-1).expand(log_det_prior.shape)
        else:
            ivd = inv_var_diag[y]
            if cfg.var_dim == 'scalar':
                ivd = ivd[..., None]
            trace = torch.sum(var * ivd, dim=-1)
            log_det_prior = ldp[y]
            log_det = torch.sum(log_var, dim=-1)
    else:
        ivd = inv_var_diag if cfg.var_dim != 'scalar' else inv_var_diag[None]
        trace = torch.sum(var * ivd, dim=-1)
        log_det = torch.sum(log_var, dim=-1)
        log_det_prior = ldp.expand(log_det.shape)

    distance = _mahala(cfg, params, mu, y, all_classes)
    var_kl = (trace - log_det + log_det_prior - K).to(dt)
    kl = 0.5 * (distance + var_weighting * var_kl)
    return {'trace': trace.to(dt), 'log_det': log_det.to(dt),
            'log_det_prior': log_det_prior.to(dt),
            'distance': distance, 'var_kl': var_kl, 'kl': kl}


def _tilted_kl(cfg, params, mu, y, all_classes):
    distance = _mahala(cfg, params, mu, y, all_classes)
    mu_norm = torch.sqrt(distance)
    kl = 0.5 * torch.square(mu_norm - cfg.tau)
    return {'distance': distance, 'mu_norm': mu_norm,
            'var_kl': torch.zeros_like(mu_norm), 'kl': kl}


def _uniform_kl(cfg, params, mu, log_var, y, var_weighting, all_classes):
    tau, alpha, c = cfg.tau, cfg.uniform_log_rho, _LOG_2PI
    mu_c = _centered(cfg, params, mu, y, all_classes)
    if all_classes and cfg.conditional:
        log_var = log_var[None].expand(mu_c.shape)
    distance = torch.square(mu_c)
    span = 2 * math.sqrt(3.0) * torch.exp(0.5 * log_var)
    a = mu_c - 0.5 * span
    b = mu_c + 0.5 * span
    a_ = torch.clamp(a, -tau, tau)
    b_ = torch.clamp(b, -tau, tau)
    elogq = -0.5 * log_var - 0.5 * math.log(12.0)     # -log(span)
    neg_elogrho = (c + distance + torch.square(span) / 12) / 2
    neg_elogrho = neg_elogrho + (alpha - c / 2) * (b_ - a_) / span
    neg_elogrho = neg_elogrho - (b_ ** 3 - a_ ** 3) / span / 6
    var_kl = torch.sum(elogq + alpha, dim=-1)
    kl = torch.maximum(torch.sum(elogq, dim=-1)
                       + torch.sum(neg_elogrho, dim=-1), var_kl)
    kl = kl + (var_weighting - 1.0) * var_kl
    return {'distance': torch.sum(distance, dim=-1),
            'var_kl': 2 * var_kl, 'kl': kl}


def prior_log_density(cfg: PriorConfig, params: Params, z: torch.Tensor,
                      y: Optional[torch.Tensor] = None,
                      all_classes: bool = False) -> torch.Tensor:
    """log p(z|y)."""
    z = z.float()
    if cfg.distribution == 'uniform':
        zc = _centered(cfg, params, z, y, all_classes)
        tail = -_LOG_2PI / 2 - torch.square(zc) / 2
        logp = torch.where(torch.abs(zc) > cfg.tau, tail,
                           torch.full_like(tail, -cfg.uniform_log_rho))
        return torch.sum(logp, dim=-1)

    u = _mahala(cfg, params, z, y, all_classes)
    ldp = log_det_per_class(cfg, params['var_param'])
    if cfg.conditional:
        if all_classes:
            ldp = ldp.reshape((cfg.num_priors,) + (1,) * (u.ndim - 1))
        else:
            ldp = ldp[y]
    logd = -_LOG_2PI * cfg.dim / 2 - u / 2 - ldp / 2
    if cfg.distribution == 'tilted':
        # tilt by the *raw* z norm, not centered (ref module/priors.py:381-383)
        zn = torch.linalg.vector_norm(z, dim=-1)
        logd = logd - (zn[None] if all_classes and cfg.conditional
                       and zn.ndim == logd.ndim - 1 else zn)
    return logd
