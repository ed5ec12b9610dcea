"""Output-noise scale sigma: static :class:`SigmaConfig` plus an explicit
:class:`SigmaState` of tensors.

Port of ``joint_vae_tpu/ops/sigma.py`` (ref ``Sigma``,
module/vae_layers/layers.py:73-213).  Modes: constant, learned (a
log-sigma parameter), rmse, decay-to-rmse, coded (an encoder head).
Training moves the state with ``update_sigma_rmse``; ``update_sigma_coded``
records the coded head's batch mean, as the reference does in eval too.
"""

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SigmaConfig:
    value: Optional[float] = None
    learned: bool = False
    is_rmse: bool = False
    sdim: int = 1
    input_dim: Optional[Tuple[int, ...]] = None   # image shape when coded
    reach: float = 1.0
    decay: float = 0.0
    max_step: Optional[float] = None
    sigma0: Optional[float] = None
    is_log: bool = False

    def __post_init__(self):
        if not (self.value is not None or self.is_rmse or self.input_dim):
            raise ValueError('sigma needs a value, is_rmse or input_dim')
        if self.is_rmse or (self.input_dim and self.value is None):
            object.__setattr__(self, 'value', 0.0)
        if self.input_dim:
            object.__setattr__(self, 'learned', True)
        if self.learned:
            object.__setattr__(self, 'is_log', True)
        if self.learned and self.is_rmse:
            raise ValueError('sigma cannot be both learned and rmse')
        if self.decay and self.learned and not self.input_dim:
            raise ValueError('a learned sigma does not decay')
        if self.sigma0 is None and not self.is_rmse:
            object.__setattr__(self, 'sigma0', self.value)
        object.__setattr__(self, 'decay', 1.0 if self.is_rmse else self.decay)
        object.__setattr__(self, 'reach',
                           self.reach if (self.decay or self.is_rmse) else None)

    @property
    def coded(self) -> bool:
        return bool(self.input_dim)

    @property
    def per_dim(self) -> bool:
        return self.sdim != 1

    @property
    def output_dim(self):
        """Shape of the encoder sigma head output when coded."""
        if not self.coded:
            return None
        return tuple(self.input_dim) if self.per_dim else (1,) * len(self.input_dim)

    @property
    def params(self) -> dict:
        d = {k: getattr(self, k) for k in
             ('value', 'learned', 'is_rmse', 'sdim', 'input_dim',
              'reach', 'decay', 'max_step', 'sigma0', 'is_log')}
        if d['input_dim'] is not None:
            d['input_dim'] = list(d['input_dim'])
        return d


@dataclasses.dataclass
class SigmaState:
    data: torch.Tensor       # (sdim,), log-space iff cfg.is_log
    rmse: torch.Tensor       # scalar, nan until first update

    def to(self, device) -> 'SigmaState':
        return SigmaState(self.data.to(device), self.rmse.to(device))


def init_sigma_state(cfg: SigmaConfig, device=None) -> SigmaState:
    v = cfg.value
    if cfg.is_log:
        v = math.log(v) if v > 0 else -30.0
    return SigmaState(
        data=torch.full((cfg.sdim,), v, dtype=torch.float32, device=device),
        rmse=torch.tensor(float('nan'), dtype=torch.float32, device=device))


def sigma_value(cfg: SigmaConfig, state: SigmaState) -> torch.Tensor:
    """RMS of the sigma vector (ref Sigma.value, layers.py:116-123)."""
    d = state.data
    v = torch.exp(2.0 * d) if cfg.is_log else torch.square(d)
    return torch.sqrt(torch.mean(v))


def update_sigma_rmse(cfg: SigmaConfig, state: SigmaState,
                      rmse: torch.Tensor) -> SigmaState:
    """Decay-to-rmse update (ref Sigma.update, layers.py:146-168): records
    ``rmse``; unless sigma is learned or does not decay, moves the data by
    decay * (reach * rmse - data), clipped to +-max_step."""
    rmse = rmse.detach()
    if cfg.learned or not cfg.decay:
        return SigmaState(data=state.data, rmse=rmse)
    delta = cfg.decay * (cfg.reach * rmse - state.data)
    if cfg.max_step:
        delta = torch.clamp(delta, -cfg.max_step, cfg.max_step)
    return SigmaState(data=state.data + delta, rmse=rmse)


def update_sigma_coded(cfg: SigmaConfig, state: SigmaState,
                       coded: torch.Tensor) -> SigmaState:
    """Record the batch mean of the coded sigma head."""
    flat = coded.reshape(-1, cfg.sdim) if cfg.per_dim else coded.reshape(-1, 1)
    return SigmaState(data=torch.mean(flat, dim=0).detach(), rmse=state.rmse)
