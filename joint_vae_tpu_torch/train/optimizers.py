"""Optimizer: adam/sgd + per-epoch exponential LR decay + grad clipping.

Port of ``joint_vae_tpu/train/optimizers.py`` (ref ``module/optimizers.py``)
as a small functional optimizer over named tensors that mirrors the JAX
package's optax chain step for step:

- ``clip_by_global_norm`` (optax's form: the updates are kept when their
  global norm is below the limit, else scaled by limit / norm);
- an injected learning rate (``set_learning_rate`` per epoch), around
- ``add_decayed_weights`` *into the gradient* (torch Adam's L2, not AdamW),
  then ``scale_by_adam`` (b1, b2, eps 1e-8, eps_root 0, bias-corrected)
  or, for SGD, ``trace`` (optax momentum: t = g + m t; nesterov g + m t),
  then a scale by -lr.

The caller applies the returned updates itself (``train/steps.py``), so
that a mask can stop frozen parameters after the optimizer, which
``torch.optim`` cannot express.  The state's moment tensors are updated in
place (``torch._foreach_*``) and the state is returned.  Its counts and
tensors map one to one onto the optax state's leaves
(``save_load/from_jax.py``).
"""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

DEFAULT_LR = {'sgd': 0.01, 'adam': 0.001}
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optim_type: str = 'adam'
    lr: float = 0.0                      # 0 -> per-type default (ref :22-23)
    lr_decay: float = 0.0                # per-epoch: lr *= (1 - lr_decay)
    weight_decay: float = 0.0
    grad_clipping: Optional[float] = None
    momentum: float = 0.0
    nesterov: bool = False
    betas: tuple = (0.9, 0.999)

    def __post_init__(self):
        if self.optim_type not in ('sgd', 'adam'):
            raise ValueError('unknown optimizer {}'.format(self.optim_type))
        if not self.lr:
            object.__setattr__(self, 'lr', DEFAULT_LR[self.optim_type])

    @property
    def params(self) -> Dict[str, Any]:
        """JSON summary mirroring ref Optimizer.params (:25-34)."""
        return {'optim_type': self.optim_type, 'lr': self.lr,
                'lr_decay': self.lr_decay, 'weight_decay': self.weight_decay,
                'grad_clipping': self.grad_clipping}

    def lr_at_epoch(self, epoch: int) -> float:
        return self.lr * (1.0 - self.lr_decay) ** epoch


@dataclasses.dataclass
class OptState:
    """The optax chain's state: ``count`` and ``learning_rate`` (a float32
    value, as optax holds it) of the injected-hyperparameter wrapper,
    ``adam_count`` of ``scale_by_adam``, and per-parameter ``mu`` / ``nu``
    (adam) or ``trace`` (sgd with momentum), keyed by parameter name."""
    learning_rate: float
    count: int = 0
    adam_count: int = 0
    mu: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    trace: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (a device scalar)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """The chain of :class:`OptimizerConfig`: ``init`` and ``update``."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        cfg = self.cfg
        st = OptState(learning_rate=as_float32(cfg.lr))
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        if cfg.optim_type == 'adam':
            st.mu, st.nu = zeros(), zeros()
        elif cfg.momentum:
            st.trace = zeros()
        return st

    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], OptState]:
        """-> (updates to add to the parameters, the new state).  ``grads``
        and ``params`` share their keys; ``grads`` is not modified."""
        cfg = self.cfg
        names = list(grads)
        g = [grads[k] for k in names]
        if cfg.grad_clipping:
            norm = global_norm(g)
            scale = torch.where(norm < cfg.grad_clipping,
                                torch.ones_like(norm),
                                cfg.grad_clipping / norm)
            g = torch._foreach_mul(g, scale)
        if cfg.weight_decay:
            g = torch._foreach_add(g, [params[k] for k in names],
                                   alpha=cfg.weight_decay)
        if cfg.optim_type == 'adam':
            b1, b2 = cfg.betas
            mu = [state.mu[k] for k in names]
            nu = [state.nu[k] for k in names]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            state.adam_count += 1
            t = state.adam_count
            den = torch._foreach_div(nu, 1.0 - b2 ** t)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, ADAM_EPS)
            u = torch._foreach_div(mu, 1.0 - b1 ** t)
            torch._foreach_div_(u, den)
        elif cfg.momentum:
            tr = [state.trace[k] for k in names]
            torch._foreach_mul_(tr, cfg.momentum)
            torch._foreach_add_(tr, g)
            u = (torch._foreach_add(g, tr, alpha=cfg.momentum)
                 if cfg.nesterov else [x.clone() for x in tr])
        else:
            u = [x.clone() for x in g]
        torch._foreach_mul_(u, -state.learning_rate)
        state.count += 1
        return dict(zip(names, u)), state


def build_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(cfg)


def as_float32(v: float) -> float:
    return float(np.float32(v))


def set_learning_rate(opt_state: OptState, lr: float) -> OptState:
    """Set the injected LR (the per-epoch decay), rounded to float32."""
    opt_state.learning_rate = as_float32(lr)
    return opt_state


def get_learning_rate(opt_state: OptState) -> float:
    return float(opt_state.learning_rate)


def format_optimizer(cfg: OptimizerConfig, level: int = 10) -> str:
    """Human string mirroring ref Optimizer.__format__ (:83-115), used in the
    job-directory naming scheme."""
    s_ = [cfg.optim_type, 'lr={:g}'.format(cfg.lr)]
    if cfg.lr_decay:
        s_.append('decay={:g}'.format(cfg.lr_decay))
    else:
        level -= 1
    extras = []
    if cfg.optim_type == 'sgd':
        if cfg.momentum:
            extras.append('momentum={:g}'.format(cfg.momentum))
        if cfg.nesterov:
            extras.append('nesterov')
    if cfg.weight_decay:
        extras.append('weight_decay={:g}'.format(cfg.weight_decay))
    if extras:
        s_.append('--'.join(extras))
    return '--'.join(s_[:level])
