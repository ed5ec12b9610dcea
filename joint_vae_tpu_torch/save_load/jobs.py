"""Job directories: read and write the JAX package's job schema.

Port of ``joint_vae_tpu/save_load/jobs.py``::

    <job_dir>/
      params.json        architecture (CVNetConfig.architecture + job_number)
      train_params.json  training parameters (beta, gamma, sigma, optimizer...)
      test.json          accuracy results {epoch: {method: {...}}}
      ood.json           OOD results {epoch: {set: {method: {...}}}}
      history.json       per-epoch training history
      state.npz          params/... + batch_stats/... + sigma_state/...
                         + counters/epoch, counters/step
      optimizer.npz      the optax chain's state (``from_jax.py``)
      deleted|derailed   sentinel files

A job written by either package loads in the other and resumes training
there: ``load_job`` converts the JAX arrays with ``from_jax.py`` and
``save_job`` writes the same keys back.  The JAX package's sampling key
(``rng``) has no counterpart: a loaded job's generator is seeded from its
step counter.  Sharded checkpoints are read by the JAX package only.
"""

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, module_device, resolve_device
from ..models.cvnet import CVNet, CVNetConfig, init_weights
from ..ops.sigma import SigmaState
from ..train.optimizers import OptimizerConfig
from ..train.state import TrainState, create_train_state
from .checkpoint import load_arrays, load_json, save_arrays, save_json
from .from_jax import (jax_to_opt_state, jax_to_state_dict, opt_state_to_jax,
                       state_dict_to_jax)

SENTINELS = ('deleted', 'derailed')


@dataclasses.dataclass
class Job:
    model_cfg: CVNetConfig
    state: TrainState
    opt_cfg: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    training_parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    train_history: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {'epochs': 0})
    testing: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    ood_results: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    job_number: int = 0
    saved_dir: Optional[str] = None

    @property
    def model(self) -> CVNet:
        return self.state.model

    @property
    def sigma_state(self) -> SigmaState:
        return self.state.sigma_state

    @property
    def device(self) -> torch.device:
        return module_device(self.model)

    @property
    def trained(self) -> int:
        return int(self.train_history.get('epochs', 0))


def default_training_parameters(cfg: CVNetConfig,
                                opt_cfg: OptimizerConfig) -> Dict[str, Any]:
    """ref cvae.py:380-391."""
    return {'sigma': cfg.sigma_cfg.params,
            'beta': cfg.beta, 'gamma': cfg.gamma,
            'latent_sampling': cfg.latent_sampling,
            'set': None, 'data_augmentation': [],
            'pretrained_features': None, 'pretrained_upsampler': None,
            'epochs': 0, 'batch_size': None, 'fine_tuning': [],
            'optimizer': opt_cfg.params}


def new_job(model_cfg: CVNetConfig, opt_cfg: Optional[OptimizerConfig] = None,
            seed: int = 0, job_number: int = 0,
            device: DeviceLike = None) -> Job:
    """A fresh job: weights from a numpy seed (``init_weights``), a fresh
    optimizer state, the generator seeded with ``seed``; on the card
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OptimizerConfig()
    model = init_weights(CVNet(model_cfg), seed).to(dev).eval()
    job = Job(model_cfg=model_cfg, opt_cfg=opt_cfg,
              state=create_train_state(model, opt_cfg, seed),
              job_number=job_number)
    job.training_parameters = default_training_parameters(model_cfg, opt_cfg)
    job.testing = {0: {m: {'n': 0, 'epochs': 0, 'accuracy': 0}
                       for m in model_cfg.predict_methods}}
    return job


def save_job(job: Job, job_dir: str):
    """Write the job directory in the JAX package's schema."""
    os.makedirs(job_dir, exist_ok=True)
    arch = dict(job.model_cfg.architecture)
    arch['job_number'] = job.job_number
    save_json(arch, os.path.join(job_dir, 'params.json'))
    save_json(job.training_parameters, os.path.join(job_dir, 'train_params.json'))
    save_json(job.testing, os.path.join(job_dir, 'test.json'))
    save_json(job.ood_results, os.path.join(job_dir, 'ood.json'))
    save_json(job.train_history, os.path.join(job_dir, 'history.json'))
    st = job.state
    arrays = state_dict_to_jax(st.model)
    arrays['sigma_state/data'] = st.sigma_state.data.detach().cpu().numpy()
    arrays['sigma_state/rmse'] = st.sigma_state.rmse.detach().cpu().numpy()
    arrays['counters/epoch'] = np.asarray(st.epoch, np.int32)
    arrays['counters/step'] = np.asarray(st.step, np.int32)
    save_arrays(os.path.join(job_dir, 'state.npz'), arrays)
    save_arrays(os.path.join(job_dir, 'optimizer.npz'),
                opt_state_to_jax(st.model, job.opt_cfg, st.opt_state))
    job.saved_dir = job_dir


def load_job(job_dir: str, device: DeviceLike = None) -> Job:
    """Load a job directory (written by this package or by the JAX one)
    onto ``device`` — the CUDA card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    arch = load_json(os.path.join(job_dir, 'params.json'))
    job_number = arch.pop('job_number', 0)
    tp_path = os.path.join(job_dir, 'train_params.json')
    training_parameters = load_json(tp_path) if os.path.exists(tp_path) else {}
    opt_params = dict(training_parameters.get('optimizer', {}) or {})
    known = {f.name for f in dataclasses.fields(OptimizerConfig)}
    opt_cfg = OptimizerConfig(**{k: v for k, v in opt_params.items()
                                 if k in known and v is not None})
    # beta / gamma / latent_sampling / sigma live in train_params.json and
    # shape the model, so they are merged before construction
    merged = dict(arch)
    for k in ('beta', 'gamma', 'latent_sampling', 'sigma'):
        if training_parameters.get(k) is not None:
            merged[k] = training_parameters[k]
    cfg = CVNetConfig.from_dict(merged)

    state_path = os.path.join(job_dir, 'state.npz')
    if not os.path.exists(state_path):
        raise FileNotFoundError(
            '{}: no state.npz (sharded checkpoints are read by the JAX '
            'package only)'.format(job_dir))
    arrays = load_arrays(state_path)
    model = CVNet(cfg)
    model.load_state_dict(jax_to_state_dict(model, arrays))
    model = model.to(dev).eval()
    step = int(arrays.get('counters/step', 0))
    state = create_train_state(model, opt_cfg, seed=step)
    state.epoch = int(arrays.get('counters/epoch', 0))
    state.step = step
    if 'sigma_state/data' in arrays:
        state.sigma_state = SigmaState(
            data=torch.as_tensor(arrays['sigma_state/data'],
                                 dtype=torch.float32, device=dev),
            rmse=torch.as_tensor(arrays.get('sigma_state/rmse', np.nan),
                                 dtype=torch.float32, device=dev))
    opt_path = os.path.join(job_dir, 'optimizer.npz')
    if os.path.exists(opt_path):
        jax_to_opt_state(model, opt_cfg, load_arrays(opt_path),
                         state.opt_state)
    job = Job(model_cfg=cfg, state=state, opt_cfg=opt_cfg,
              training_parameters=training_parameters, job_number=job_number,
              saved_dir=job_dir)
    for name, attr in (('test.json', 'testing'), ('ood.json', 'ood_results'),
                       ('history.json', 'train_history')):
        p = os.path.join(job_dir, name)
        if os.path.exists(p):
            setattr(job, attr, load_json(p))
    return job


def is_derailed(job_dir: str) -> bool:
    return any(os.path.exists(os.path.join(job_dir, s)) for s in SENTINELS)


def mark(job_dir: str, sentinel: str):
    """Drop a sentinel file ('deleted', 'derailed' or 'RESUMED')."""
    if sentinel not in SENTINELS + ('RESUMED',):
        raise ValueError('unknown sentinel {}'.format(sentinel))
    with open(os.path.join(job_dir, sentinel), 'w') as f:
        f.write('')
