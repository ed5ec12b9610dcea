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
step counter.  A multi-process run (or ``JVT_SHARDED_CKPT``) writes
sharded ``state.shards/`` and ``optimizer.shards/`` instead of the npz
archives (``sharded_checkpoint.py``), each rank its own chunks, and the
JSON files from rank 0; either format loads onto any mesh.  A ghost load
reads the JSON files only, for fleet queries.
"""

import dataclasses
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, module_device, resolve_device
from ..models.cvnet import CVNet, CVNetConfig, init_weights
from ..ops.sigma import SigmaState
from ..train.optimizers import OptimizerConfig
from ..train.state import TrainState, create_train_state
from ..parallel.mesh import split_names, world
from .checkpoint import (is_write_process, load_arrays, load_json,
                         save_arrays, save_json)
from .from_jax import (_entries, jax_to_opt_state, jax_to_state_dict,
                       opt_state_entries, opt_state_to_jax, state_dict_to_jax)
from .sharded_checkpoint import (MANIFEST, Leaf, barrier,
                                 is_sharded_checkpoint,
                                 load_checkpoint_sharded, sharded_write)

SENTINELS = ('deleted', 'derailed')


@dataclasses.dataclass
class Job:
    model_cfg: CVNetConfig
    state: Optional[TrainState] = None
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
        """The weights' device; the CPU for a ghost job, whose recorder
        and json tiers replay on the host."""
        if self.state is None:
            return torch.device('cpu')
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


def _sharded_default() -> bool:
    return (os.environ.get('JVT_SHARDED_CKPT', '').strip().lower()
            not in ('', '0', 'off', 'false', 'no', 'none')
            or world()[0] > 1)


def _split_axis(tkey: str, value: torch.Tensor, to_jax, split: set):
    """The JAX-layout axis of a class-split tensor (its dim 0, which a
    Dense kernel's transpose moves last), else None."""
    if tkey not in split:
        return None
    return value.ndim - 1 if to_jax is not None else 0


def state_leaves(st: TrainState) -> Dict[str, Leaf]:
    """The state.npz tree of a (possibly mesh-placed) TrainState as
    sharded-checkpoint leaves."""
    model = st.model
    split = split_names(model)
    sd = model.state_dict()
    leaves = {}
    for jkey, tkey, _, to_jax in _entries(model):
        t = sd[tkey].detach().float()
        leaves[jkey] = Leaf(t, to_jax, _split_axis(tkey, t, to_jax, split))
    leaves['sigma_state/data'] = Leaf(st.sigma_state.data.detach())
    leaves['sigma_state/rmse'] = Leaf(st.sigma_state.rmse.detach())
    leaves['counters/epoch'] = Leaf(np.asarray(st.epoch, np.int32))
    leaves['counters/step'] = Leaf(np.asarray(st.step, np.int32))
    return leaves


def opt_leaves(model: CVNet, opt_cfg: OptimizerConfig, opt_state
               ) -> Dict[str, Leaf]:
    split = split_names(model)
    return {k: Leaf(v, to_jax, None if tkey is None
                    else _split_axis(tkey, v, to_jax, split))
            for k, v, to_jax, tkey in opt_state_entries(model, opt_cfg,
                                                        opt_state)}


def save_job(job: Job, job_dir: str, save_state: bool = True,
             sharded: Optional[bool] = None, checkpointer=None):
    """Write the job directory in the JAX package's schema;
    ``save_state=False`` writes the JSON files only (results saved back
    by the test CLI).

    ``sharded`` writes per-rank ``state.shards/`` and
    ``optimizer.shards/`` instead of the npz archives; it defaults to
    ``JVT_SHARDED_CKPT`` or a world of more than one rank, and a model
    split over 'model' always saves sharded.  ``checkpointer`` (an
    ``AsyncCheckpointer``) takes a sharded save as one write (state,
    optimizer, the other format's removal) after an on-device snapshot,
    and returns; its host copies and file IO run on the worker thread
    (the caller waits on it, and calls ``barrier``, before any rank
    loads).  The JSON files and archives are rank 0's; the
    format not written is removed once the new one is on disk."""
    os.makedirs(job_dir, exist_ok=True)
    arch = dict(job.model_cfg.architecture)
    arch['job_number'] = job.job_number
    save_json(arch, os.path.join(job_dir, 'params.json'))
    save_json(job.training_parameters, os.path.join(job_dir, 'train_params.json'))
    save_json(job.testing, os.path.join(job_dir, 'test.json'))
    save_json(job.ood_results, os.path.join(job_dir, 'ood.json'))
    save_json(job.train_history, os.path.join(job_dir, 'history.json'))
    if save_state and job.state is not None:
        st = job.state
        mesh = getattr(st.model, 'mesh', None)
        if sharded is None:
            sharded = _sharded_default()
        if not sharded and (world()[0] > 1 or split_names(st.model)):
            raise ValueError('a multi-process job or a model split over '
                             "'model' saves sharded checkpoints")
        if sharded:
            snap = checkpointer is not None
            writes = (
                sharded_write(os.path.join(job_dir, 'state.shards'),
                              state_leaves(st), mesh, snapshot=snap),
                sharded_write(os.path.join(job_dir, 'optimizer.shards'),
                              opt_leaves(st.model, job.opt_cfg,
                                         st.opt_state),
                              mesh, snapshot=snap))

            def write():
                for w in writes:
                    w()
                if checkpointer is None:
                    barrier()
                _drop_stale(job_dir, '.npz')
            if checkpointer is None:
                write()
            else:
                checkpointer.submit(write)
        else:
            arrays = state_dict_to_jax(st.model)
            arrays['sigma_state/data'] = st.sigma_state.data.detach().cpu().numpy()
            arrays['sigma_state/rmse'] = st.sigma_state.rmse.detach().cpu().numpy()
            arrays['counters/epoch'] = np.asarray(st.epoch, np.int32)
            arrays['counters/step'] = np.asarray(st.step, np.int32)
            save_arrays(os.path.join(job_dir, 'state.npz'), arrays)
            save_arrays(os.path.join(job_dir, 'optimizer.npz'),
                        opt_state_to_jax(st.model, job.opt_cfg, st.opt_state))
            _drop_stale(job_dir, '.shards')
    job.saved_dir = job_dir


def _drop_stale(job_dir: str, kind: str):
    """Remove the other checkpoint format after a save (rank 0's: the npz
    archives and the manifest are its files), so that a copy of the job
    that loses its mtimes cannot resurrect older weights."""
    if not is_write_process():
        return
    for stem in ('state', 'optimizer'):
        p = os.path.join(job_dir, stem + kind)
        try:
            if kind == '.shards':
                if os.path.isdir(p):
                    shutil.rmtree(p)
            elif os.path.exists(p):
                os.unlink(p)
        except OSError:
            pass


def _load_arrays(job_dir: str, stem: str) -> Dict[str, np.ndarray]:
    """Checkpoint arrays for ``stem``: ``<stem>.npz`` or the sharded
    ``<stem>.shards/`` stitched back.  When both exist (a job that
    switched formats mid-life), the newer one wins, as in the JAX
    package."""
    npz = os.path.join(job_dir, stem + '.npz')
    shards = os.path.join(job_dir, stem + '.shards')
    have_npz = os.path.exists(npz)
    have_shards = is_sharded_checkpoint(shards)
    if have_npz and have_shards:
        if os.path.getmtime(npz) >= os.path.getmtime(
                os.path.join(shards, MANIFEST)):
            return load_arrays(npz)
        return load_checkpoint_sharded(shards)
    if have_npz:
        return load_arrays(npz)
    if not have_shards:
        raise FileNotFoundError('{}: no {}.npz and no sharded {}.shards/'
                                .format(job_dir, stem, stem))
    return load_checkpoint_sharded(shards)


def _has_checkpoint(job_dir: str, stem: str) -> bool:
    return (os.path.exists(os.path.join(job_dir, stem + '.npz'))
            or is_sharded_checkpoint(os.path.join(job_dir, stem + '.shards')))


def load_job(job_dir: str, device: DeviceLike = None, load_state: bool = True,
             ghost: bool = False, strict: bool = True) -> Job:
    """Load a job directory (written by this package or by the JAX one).

    - ``ghost=True``: the configs and the JSON files only, ``state=None``;
      no module is built and no device is touched (fleet queries);
    - ``load_state=False``: a fresh model (``init_weights`` seed 0) on
      ``device``, as the JAX package builds a fresh state;
    - ``strict=False``: parameters the checkpoint lacks keep their fresh
      values (the WIM transfer path).

    Otherwise the weights go onto ``device``: the CUDA card unless the
    caller asks for the CPU.  ``state.npz`` or a sharded
    ``state.shards/`` (the newer when both exist)."""
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
    job = Job(model_cfg=cfg, opt_cfg=opt_cfg,
              training_parameters=training_parameters, job_number=job_number,
              saved_dir=job_dir)
    for name, attr in (('test.json', 'testing'), ('ood.json', 'ood_results'),
                       ('history.json', 'train_history')):
        p = os.path.join(job_dir, name)
        if os.path.exists(p):
            setattr(job, attr, load_json(p))
    if ghost:
        return job

    dev = resolve_device(device)
    model = CVNet(cfg)
    if not (load_state and strict):
        init_weights(model, 0)
    arrays = _load_arrays(job_dir, 'state') if load_state else {}
    if load_state:
        model.load_state_dict(jax_to_state_dict(model, arrays, strict=strict))
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
    if load_state and _has_checkpoint(job_dir, 'optimizer'):
        jax_to_opt_state(model, opt_cfg, _load_arrays(job_dir, 'optimizer'),
                         state.opt_state)
    job.state = state
    return job


def is_derailed(job_dir: str) -> bool:
    return any(os.path.exists(os.path.join(job_dir, s)) for s in SENTINELS)


def mark(job_dir: str, sentinel: str):
    """Drop a sentinel file ('deleted', 'derailed' or 'RESUMED'); rank
    0's in a multi-process run."""
    if sentinel not in SENTINELS + ('RESUMED',):
        raise ValueError('unknown sentinel {}'.format(sentinel))
    if not is_write_process():
        return
    with open(os.path.join(job_dir, sentinel), 'w') as f:
        f.write('')
