"""TrainState: the model, its optimizer state, the sigma state, the random
generator and the counters of a training run.

Port of ``joint_vae_tpu/train/state.py``.  The parameters live in the
model (an ``nn.Module``, updated in place by the train step); the grad
mask is static per parameter name, decided on the JAX parameter path of
each tensor (``save_load/from_jax.py::param_paths``) exactly as the JAX
package decides it, and the prior-mean thaw at ``epoch >= freeze_means``
is applied on top (ref requires_grad flags and thaw_means).
"""

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import module_device
from ..models.cvnet import CVNet
from ..ops.sigma import SigmaState, init_sigma_state
from ..save_load.from_jax import param_paths
from .optimizers import OptimizerConfig, OptState, build_optimizer


@dataclasses.dataclass
class TrainState:
    model: CVNet
    opt_state: OptState
    sigma_state: SigmaState
    generator: torch.Generator
    epoch: int = 0
    step: int = 0

    @property
    def device(self) -> torch.device:
        return module_device(self.model)


def named_params(model: CVNet) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def make_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def fold_in(seed: int, i: int) -> int:
    """A seed derived from ``(seed, i)``, the counterpart of JAX's
    ``fold_in(PRNGKey(seed), i)``: one stream per stage or batch."""
    return int(np.random.SeedSequence([int(seed), int(i)]).generate_state(1)[0])


def create_train_state(model: CVNet, opt_cfg: OptimizerConfig,
                       seed: int = 0,
                       sigma_state: Optional[SigmaState] = None
                       ) -> TrainState:
    """A fresh optimizer state for ``model`` (on its device), the config's
    initial sigma state unless one is given, and a generator on the
    model's device seeded with ``seed``."""
    dev = module_device(model)
    opt_state = build_optimizer(opt_cfg).init(named_params(model))
    if sigma_state is None:
        sigma_state = init_sigma_state(model.cfg.sigma_cfg, dev)
    return TrainState(model=model, opt_state=opt_state,
                      sigma_state=sigma_state,
                      generator=make_generator(dev, seed))


def grad_mask(model: CVNet, frozen_modules: Sequence[str] = ()
              ) -> Dict[str, float]:
    """Static 0/1 mask by parameter name: which parameters may train.

    Prior means train iff learned_means (the thaw applies separately);
    the prior variance iff it is learned (not scalar); sigma_param iff
    sigma is learned; ``frozen_modules`` (pretrained features/upsampler)
    never train, matched as prefixes of any name on the JAX path, so that
    'features' freezes 'features_stack'."""
    cfg = model.cfg
    frozen = tuple(frozen_modules)
    paths = param_paths(model)
    mask = {}
    for name in named_params(model):
        names = paths[name].split('/')
        m = 1.0
        if frozen and any(n.startswith(f) for n in names for f in frozen):
            m = 0.0
        elif 'prior' in names and 'mean' in names:
            m = 1.0 if cfg.prior.learned_means else 0.0
        elif 'prior' in names and 'var_param' in names:
            m = 1.0 if cfg.prior.learned_var else 0.0
        elif 'sigma_param' in names:
            m = 1.0 if cfg.sigma_cfg.learned else 0.0
        mask[name] = m
    return mask


def thaw_factor(model: CVNet, epoch: int) -> Optional[float]:
    """The prior means' thaw factor at ``epoch`` (``epoch >=
    freeze_means``; ref thaw_means, module/priors.py:134-140), or None
    when the means never freeze."""
    cfg = model.cfg
    if cfg.prior.learned_means and cfg.prior.freeze_means:
        return float(epoch >= cfg.prior.freeze_means)
    return None


def apply_grad_mask(model: CVNet, tensors: Dict[str, torch.Tensor],
                    mask: Dict[str, float], epoch: int,
                    thaw: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """mask * tensors, the prior means also times the thaw factor
    (:func:`thaw_factor` at ``epoch``, or ``thaw``, a 0-dim device tensor
    holding it, which a captured step reads as the epochs move).  Tensors
    whose factor is 1 pass through as they are."""
    if thaw is None:
        thaw = thaw_factor(model, epoch)
        thaw = 1.0 if thaw is None else thaw
    out = {}
    for name, t in tensors.items():
        s = mask[name]                  # a float: never read from the card
        if name == 'prior.mean' and s != 0.0:
            if isinstance(thaw, torch.Tensor):
                out[name] = t * (thaw if s == 1.0 else s * thaw)
                continue
            s = s * thaw
        out[name] = t if s == 1.0 else t * s
    return out
