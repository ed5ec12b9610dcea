"""The trainer: epoch loop with periodic evaluation, checkpointing, live
output and signal-aware stopping.

Port of ``joint_vae_tpu/train/trainer.py`` (ref ``train_model``,
cvae.py:2081-2547):

- seeded validation split persisted in train_params (ref :2155-2167)
- per-epoch: warmup ramps, per-epoch LR decay, NaN guard (marks the job
  dir 'derailed'), live EpochOutput rows, validation/test loss history,
  per-epoch checkpoint save
- graceful stops on signal levels (ref :2377-2542)
- the hot loop is one eager train step (train/steps.py); host batches go
  to the card through pinned memory, and the step metrics stay on the
  card until they are pulled together every ``metrics_every`` steps (8 on
  the card, 1 on the CPU), so the host does not wait for each step.

Not ported here: the mesh, multi-process and device-resident dataset
branches, and the dataset registry (a ``trainset`` must be given).  The
in-training accuracy and OOD evaluations need the evaluation engines,
which are not ported yet: a run that would reach them raises
``NotImplementedError``.
"""

import logging
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.loaders import ArrayDataset, DataLoader
from ..models.cvnet import CVNet
from ..models.evaluate import evaluate
from ..save_load.jobs import Job, mark, save_job
from ..utils.print_log import EpochOutput
from ..utils.signaling import SIGHandler
from .optimizers import set_learning_rate
from .state import TrainState, make_generator
from .steps import make_train_step, pull_metrics

_ENGINES = ('the evaluation engines (evals/engines.py: accuracy, '
            'ood_detection_rates) are not ported yet; pass final_test=False '
            'and final_ood=False, and no full tests or oodsets in training')


def split_validation(dataset: ArrayDataset, validation: int, seed: int):
    """Deterministic validation split (ref cvae.py:2155-2167)."""
    if not validation:
        return dataset, None
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(dataset))
    return dataset.subset(perm[validation:]), dataset.subset(perm[:validation])


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``; to the card through pinned memory, so
    that the copy does not wait for the card's queue."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def train_model(job: Job,
                trainset: ArrayDataset,
                testset: Optional[ArrayDataset] = None,
                oodsets: Optional[Sequence[ArrayDataset]] = None,
                epochs: int = 2,
                batch_size: int = 64,
                test_batch_size: int = 512,
                validation: int = 0,
                data_augmentation: Sequence[str] = (),
                warmup=(0, 0), warmup_gamma=(0, 0),
                full_test_every: int = 10,
                ood_detection_every: int = 10,
                save_dir: Optional[str] = None,
                signal_handler: Optional[SIGHandler] = None,
                outputs: Optional[EpochOutput] = None,
                seed: int = 0,
                train_accuracy: bool = False,
                fine_tuning: bool = False,
                final_test: bool = True,
                final_ood: bool = True,
                metrics_every: int = 0) -> Job:
    """Train ``job.state`` in place on the job's device; returns the job."""
    if trainset is None:
        raise NotImplementedError('train_model needs a trainset: the dataset '
                                  'registry (data/registry.py) is not ported '
                                  'yet')
    cfg = job.model_cfg
    state = job.state
    model = state.model
    dev = state.device
    outputs = outputs or EpochOutput()
    signal_handler = signal_handler or _NullSignal()

    # persisted warmup + validation seed (ref cvae.py:2196-2202, 2155-2167)
    tp = job.training_parameters
    w_prev = tp.get('warmup', [0, 0])
    wg_prev = tp.get('warmup_gamma', [0, 0])
    warmup = [max(a, b) for a, b in zip(list(warmup), w_prev)]
    warmup_gamma = [max(a, b) for a, b in zip(list(warmup_gamma), wg_prev)]
    tp['warmup'], tp['warmup_gamma'] = warmup, warmup_gamma
    tp.setdefault('validation_seed', seed or 1)
    tp['set'] = getattr(trainset, 'name', tp.get('set'))
    tp['batch_size'] = batch_size
    tp['data_augmentation'] = list(data_augmentation)
    tp['epochs'] = max(tp.get('epochs') or 0, epochs)
    trainset, validationset = split_validation(trainset, validation,
                                               tp['validation_seed'])

    frozen = tuple(tp.get('frozen_modules') or ())
    step = make_train_step(model, job.opt_cfg, tuple(warmup),
                           tuple(warmup_gamma), frozen)
    loader = DataLoader(trainset, batch_size, shuffle=True, seed=seed,
                        data_augmentation=data_augmentation, drop_last=True)
    per_epoch = len(loader)

    first_epoch = job.trained
    for epoch in range(first_epoch, epochs):
        full_test = ((epoch - first_epoch) % full_test_every == 0
                     and epoch > first_epoch)
        ood_now = ((epoch - first_epoch) % ood_detection_every == 0
                   and epoch > first_epoch and oodsets)

        if signal_handler.sig > 3:
            logging.warning('Abruptly breaking training loop (%s)',
                            signal_handler)
            break
        if signal_handler.sig > 2 or (full_test and signal_handler.sig > 1):
            logging.warning('Breaking training loop after %d epochs (%s)',
                            epoch, signal_handler)
            break

        if save_dir and epoch == first_epoch:
            # end-of-epoch saves cover later iterations; this initial save
            # persists the fresh/resumed job before any training
            save_job(job, save_dir)

        if (ood_now and testset is not None) or (
                full_test and testset is not None and cfg.predict_methods):
            raise NotImplementedError(_ENGINES)

        # per-epoch LR decay (ref optimizer.update_lr, optimizers.py:123-127)
        set_learning_rate(state.opt_state, job.opt_cfg.lr_at_epoch(epoch))
        state.epoch = epoch

        t0 = time.time()
        running: Dict[str, float] = {}
        metrics: Dict[str, float] = {}
        batches_run = 0
        me = metrics_every or (1 if dev.type == 'cpu' else 8)
        pending = []
        for i, (x, y) in enumerate(loader):
            state, m = step(state, to_device(x, dev), to_device(y, dev))
            batches_run += 1
            pending.append(m)
            if (len(pending) < me and i != per_epoch - 1
                    and signal_handler.sig <= 3):
                continue
            got = pull_metrics(pending)
            pending = []
            metrics = got[-1]
            for mts in got:
                for k, v in mts.items():
                    running[k] = running.get(k, 0.0) + v
            if not np.isfinite(running.get('total', 0.0)):
                bad = next((i - len(got) + 1 + k for k, mts in enumerate(got)
                            if not np.isfinite(mts.get('total', 0.0))), i)
                logging.error('non-finite loss at epoch %d batch %d — '
                              'marking derailed', epoch, bad)
                if save_dir:
                    mark(save_dir, 'derailed')
                return job
            t_per_i = (time.time() - t0) / (i + 1)
            mean = {k: running[k] / (i + 1) for k in running}
            outputs.results(i, per_epoch, epoch + 1, epochs, preambule='train',
                            losses={k: mean.get(k, np.nan)
                                    for k in cfg.loss_components
                                    if k in mean},
                            metrics={k: mean.get(k, np.nan)
                                     for k in cfg.metrics if k in mean},
                            accuracy=({'train': mean['train_acc']}
                                      if (train_accuracy
                                          and 'train_acc' in mean) else None),
                            time_per_i=t_per_i, batch_size=batch_size)
            if signal_handler.sig > 3:
                break

        checkpoint = {
            # divide by the batches actually run (a signal may break the
            # loop mid-epoch)
            'train_loss': {k: running.get(k, np.nan) / max(batches_run, 1)
                           for k in cfg.loss_components if k in running},
            **({'train_accuracy': running['train_acc'] / max(batches_run, 1)}
               if 'train_acc' in running else {}),
            'train_measures': {k: float(metrics[k]) for k in cfg.metrics
                               if k in metrics},
            'lr': job.opt_cfg.lr_at_epoch(epoch),
        }

        if validationset is not None:
            vl, vm = _mean_losses(model, state, validationset,
                                  test_batch_size, epoch)
            checkpoint['validation_loss'] = vl
            checkpoint['validation_measures'] = vm
        if testset is not None and (
                epoch == epochs - 1
                or (epoch - first_epoch) % full_test_every == full_test_every - 1):
            tl, tm = _mean_losses(model, state, testset, test_batch_size,
                                  epoch)
            checkpoint['test_loss'] = tl
            checkpoint['test_measures'] = tm
        job.train_history[epoch + 1] = checkpoint
        job.train_history['epochs'] = epoch + 1
        if fine_tuning:
            tp.setdefault('fine_tuning', []).append(epoch)

        if save_dir and signal_handler.sig <= 3:
            save_job(job, save_dir)

    # final full evaluation (ref cvae.py:2505-2547)
    if signal_handler.sig <= 3 and testset is not None:
        if (cfg.predict_methods and final_test) or (oodsets and final_ood):
            raise NotImplementedError(_ENGINES)
        if save_dir:
            save_job(job, save_dir)
    return job


def _mean_losses(model: CVNet, state: TrainState, dataset: ArrayDataset,
                 batch_size: int, epoch: int):
    """-> (mean per-component losses, mean measures incl. rmse/dB) with
    labels (validation/test history tracking); the latent noise comes from
    a generator seeded with the epoch, and the batch means are pulled from
    the card once."""
    dev = state.device
    gen = make_generator(dev, epoch)
    per_batch = []
    for x, y in DataLoader(dataset, batch_size, shuffle=False):
        out = evaluate(model, to_device(x, dev), to_device(y, dev),
                       sigma_state=state.sigma_state, train=False,
                       generator=gen)
        per_batch.append(
            {**{'loss/' + k: torch.mean(v) for k, v in out.losses.items()},
             **{'measure/' + k: torch.mean(v)
                for k, v in out.measures.items()}})
    sums: Dict[str, float] = {}
    for row in pull_metrics(per_batch):
        for k, v in row.items():
            sums[k] = sums.get(k, 0.0) + v
    n = max(len(per_batch), 1)
    losses = {k[5:]: v / n for k, v in sums.items() if k.startswith('loss/')}
    measures = {k[8:]: v / n for k, v in sums.items()
                if k.startswith('measure/')}
    if 'mse' in measures:
        measures['rmse'] = float(np.sqrt(max(measures['mse'], 0.0)))
        if measures.get('xpow'):
            # SNR in dB (ref metric, cvae.py:97-101)
            measures['dB'] = float(10 * np.log10(
                measures['xpow'] / max(measures['mse'], 1e-30)))
    return losses, measures


class _NullSignal:
    sig = 0
