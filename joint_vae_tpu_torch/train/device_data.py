"""Training from a dataset that lives on the card.

Port of ``joint_vae_tpu/train/device_data.py``.  The whole training set is
copied to the card once; each epoch draws a permutation there, and each
step gathers its batch's rows of the set straight into the step graph's
input buffers (``train/graphs.py``: two gathers, x and y, outside the
graph), so the loop moves no image from the host.

8-bit data (uint8 sets, and float sets in [0, 1] that are exactly k/255,
as MNIST, CIFAR and ImageNet files are) stays uint8 on the card: a
quarter of float32's bytes in memory and in the epoch's gather.  The step
turns its batch into float32 as ``x * float32(1/255)``, a multiplication
as in the JAX package, which can differ by one ulp from the host loader's
``k / 255``: a run fed from the card is compared with a run fed from the
card.

The train step is ``train/steps.py``'s, a CUDA graph on the card.
``fused=True`` is the port of the JAX package's fused whole-epoch
program (its ``fori_loop`` over the steps): per epoch the permutation,
the metric sums zeroed, then per step the batch's gather and one replay,
the step's metrics summed inside the graph as JAX's loop carry sums
them, pulled once at the epoch's end.  The
permutation comes from a generator on the card seeded with (seed, epoch):
``jax.random.permutation`` cannot be reproduced in torch, and the tests
inject JAX's through :func:`epoch_permutation`.
"""

import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.loaders import ArrayDataset
from ..device import DeviceLike, resolve_device
from ..models.cvnet import CVNet
from .optimizers import OptimizerConfig, set_learning_rate
from .steps import TrainStep, pull_metrics

_ROWS = 4096              # images per host-to-card copy while uploading


def _is_eightbit(data: np.ndarray) -> bool:
    """True when float data lies in [0, 1] and is k/255 to 1e-6 (the JAX
    package's ``storage='auto'`` test), read a chunk of rows at a time."""
    if not data.size:
        return False
    for i in range(0, len(data), _ROWS):
        d = data[i:i + _ROWS]
        q = np.round(d * 255.0)
        if (float(d.min()) < 0.0 or float(d.max()) > 1.0
                or float(np.abs(q / 255.0 - d).max()) >= 1e-6):
            return False
    return True


def _upload(data: np.ndarray, dtype: torch.dtype, device: torch.device,
            quantize: bool = False) -> torch.Tensor:
    """``data`` on ``device`` as ``dtype``, copied a chunk of rows at a time
    (a memmap is read once, and no whole-set host copy is made);
    ``quantize`` stores round(data * 255) as uint8."""
    out = torch.empty(data.shape, dtype=dtype, device=device)
    for i in range(0, len(data), _ROWS):
        d = np.asarray(data[i:i + _ROWS])
        if quantize:
            d = np.round(d * 255.0).astype(np.uint8)
        out[i:i + len(d)].copy_(torch.from_numpy(np.array(d)))
    return out


class DeviceDataset:
    """The whole dataset as tensors on the card: 8-bit data as uint8 (see
    the module docstring; uint8 data, the ingest cache's, is uploaded as it
    is), any other as float32.  Labels are int32."""

    def __init__(self, dataset: ArrayDataset, device: DeviceLike = None):
        dev = resolve_device(device)
        data = dataset.data
        if data.dtype == np.uint8:
            x = _upload(data, torch.uint8, dev)
        elif _is_eightbit(data):
            x = _upload(data, torch.uint8, dev, quantize=True)
        else:
            x = _upload(data, torch.float32, dev)
        self.x = x
        self.y = torch.from_numpy(
            np.asarray(dataset.targets, np.int32)).to(dev)
        self.n = len(dataset)
        self.name = dataset.name

    def __len__(self):
        return self.n


def epoch_permutation(n: int, seed: int, epoch: int,
                      device: torch.device) -> torch.Tensor:
    """The epoch's order of the set: ``randperm`` from a generator on
    ``device`` seeded with a 32-bit hash of (seed, epoch) (the CPU
    generator reads 32 bits of its seed)."""
    gen = torch.Generator(device=device).manual_seed(
        zlib.crc32('{}:{}'.format(int(seed), int(epoch)).encode()))
    return torch.randperm(n, generator=gen, device=device)


def make_device_train_step(model: CVNet, opt_cfg: OptimizerConfig,
                           batch_size: int,
                           warmup: Tuple[int, int] = (0, 0),
                           warmup_gamma: Tuple[int, int] = (0, 0),
                           frozen_modules: Tuple[str, ...] = (),
                           graphed: Optional[bool] = None):
    """``step(state, data_x, data_y, i, eps=None, perm=None) -> (state,
    metrics)``: ``train/steps.py``'s step (with its warmup ramps) on batch
    ``i``: rows ``perm[i * batch_size:(i + 1) * batch_size]`` of the
    arrays, or with no ``perm`` that slice of arrays already shuffled,
    gathered into the step's input buffers.  The step sums its metrics
    into ``step.graph.sums`` (:func:`make_device_epoch_fn`)."""
    step = TrainStep(model, opt_cfg, warmup, warmup_gamma, frozen_modules,
                     graphed=graphed)

    def device_step(state, data_x, data_y, i: int,
                    eps: Optional[torch.Tensor] = None,
                    perm: Optional[torch.Tensor] = None):
        rows = slice(i * batch_size, (i + 1) * batch_size)
        if perm is not None:
            rows = perm[rows]
        return step.gather(state, data_x, data_y, rows, eps)

    device_step.graph = step.graph
    return device_step


def make_device_epoch_fn(model: CVNet, opt_cfg: OptimizerConfig,
                         batch_size: int, n_batches: int,
                         warmup: Tuple[int, int] = (0, 0),
                         warmup_gamma: Tuple[int, int] = (0, 0),
                         frozen_modules: Tuple[str, ...] = ()):
    """``epoch(state, x, y, perm) -> (state, mean metrics)``: the fused
    whole-epoch program — ``n_batches`` steps over the rows of the arrays
    in ``perm``'s order, each step's metrics summed on the card inside the
    step (as JAX's loop carry sums them, in step order); returns their
    means over the epoch as tensors on the card (nothing waits for it)."""
    step = make_device_train_step(model, opt_cfg, batch_size, warmup,
                                  warmup_gamma, frozen_modules)

    def epoch(state, data_x, data_y, perm):
        return _fused_epoch(step, state, data_x, data_y, perm, n_batches)

    epoch.graph = step.graph
    return epoch


def _fused_epoch(step, state, data_x, data_y, perm, n_batches: int):
    """``n_batches`` device-fed steps in ``perm``'s order, their metrics
    summed inside the step; -> (state, the means)."""
    step.graph.reset_sums()
    for i in range(n_batches):
        state, _ = step(state, data_x, data_y, i, perm=perm)
    return state, step.graph.metrics(step.graph.sums / n_batches)


def train_epochs_on_device(job, dataset: ArrayDataset, epochs: int,
                           batch_size: int,
                           warmup=(0, 0), warmup_gamma=(0, 0),
                           seed: int = 0,
                           log_every: Optional[int] = None,
                           fused: bool = True,
                           graphed: Optional[bool] = None
                           ) -> Dict[str, float]:
    """Train ``job.state`` for ``epochs`` epochs after ``job.trained`` over
    ``dataset`` held on the job's device; returns the last epoch's
    metrics.  ``warmup`` / ``warmup_gamma`` are the KL and cross-entropy
    ramps ``(start, length)`` in epochs (``train/steps.py``); every
    ``log_every`` epochs the epoch's total is printed.  ``fused=True``
    records epoch means; ``fused=False`` the last batch's (the same step
    graph either way; ``graphed=False`` runs the steps eagerly).  A set
    smaller than one batch trains nothing and returns {}."""
    state = job.state
    model = state.model
    dev = state.device
    frozen = tuple(job.training_parameters.get('frozen_modules') or ())
    dd = DeviceDataset(dataset, device=dev)
    steps_per_epoch = dd.n // batch_size
    if steps_per_epoch == 0:
        return {}
    step = make_device_train_step(model, job.opt_cfg, batch_size, warmup,
                                  warmup_gamma, frozen, graphed)
    last: Dict[str, float] = {}
    first_epoch = job.trained
    for epoch in range(first_epoch, first_epoch + epochs):
        state.epoch = epoch
        set_learning_rate(state.opt_state, job.opt_cfg.lr_at_epoch(epoch))
        perm = epoch_permutation(dd.n, seed, epoch, dev)
        if fused:
            state, metrics = _fused_epoch(step, state, dd.x, dd.y, perm,
                                          steps_per_epoch)
        else:
            for i in range(steps_per_epoch):
                state, metrics = step(state, dd.x, dd.y, i, perm=perm)
        last = pull_metrics([metrics])[0]
        job.train_history[epoch + 1] = {
            'train_loss': {k: v for k, v in last.items()
                           if k in model.cfg.loss_components},
            'lr': job.opt_cfg.lr_at_epoch(epoch)}
        job.train_history['epochs'] = epoch + 1
        if log_every and (epoch + 1) % log_every == 0:
            print('epoch {:4d}: total {:.4f}'.format(
                epoch + 1, float(last.get('total', float('nan')))))
    return last
