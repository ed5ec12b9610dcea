"""The trainer: epoch loop with periodic evaluation, checkpointing, live
output and signal-aware stopping.

Port of ``joint_vae_tpu/train/trainer.py`` (ref ``train_model``,
cvae.py:2081-2547):

- seeded validation split persisted in train_params (ref :2155-2167)
- per-epoch: warmup ramps, per-epoch LR decay, NaN guard (marks the job
  dir 'derailed'), live EpochOutput rows, validation/test loss history,
  per-epoch checkpoint save
- graceful stops on signal levels (ref :2377-2542)
- the hot loop is one train step (train/steps.py), replayed as a CUDA
  graph on the card (``graphed=False``: eager steps); host batches go
  to the card through pinned memory and are copied into the graph's
  input buffers, and the step metrics (a copy of the graph's packed
  output each step) stay on the card until they are pulled together
  every ``metrics_every`` steps (8 on the card, 1 on the CPU), so the
  host does not wait for each step;
- ``device_data=True`` holds the training set on the card instead
  (``train/device_data.py``): one permutation there per epoch, each
  batch's rows gathered into the graph's input buffers, no host batch in
  the loop.  Host augmentation needs the host loader and turns it off, as
  in the JAX package.

Per epoch, every ``ood_detection_every`` and ``full_test_every`` epochs,
and once at the end, it runs the evaluation engines (``evals/engines.py``:
``ood_detection_rates``, ``accuracy``), the in-training ones capped at
``test_sample_size`` samples.  The per-epoch validation and test losses
replay a scoring graph per batch shape on the card, held on the job
across epochs (``_mean_losses``).

``mesh`` (``parallel/mesh.py``) trains on a device mesh: the state is
placed with the sharding rules, every rank iterates the same full loader
and feeds its rows of each global batch (``aligned_global_batch``) to the
train step on the mesh (its collectives: ``parallel/shard_steps.py``), so
the data order and the noise are the one-process run's.  The
device-resident set is off on a mesh.  A multi-process run needs a mesh; its evaluations are mesh-fed.
The mesh step and the mesh-fed batches are graphs too, their collectives
captured (``train/graphs.py::graph_mode``).
"""

import logging
import time
import weakref
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.loaders import ArrayDataset, DataLoader, get_dataset
from ..device import to_device
from ..evals.engines import accuracy, ood_detection_rates
from ..models.evaluate import evaluate
from ..parallel.mesh import (current_scope, ensure_placed,
                             eval_batch_putters, mesh_scope, rows_split,
                             world)
from ..parallel.shard_steps import reduce_over_data
from ..parallel.sharded_data import aligned_global_batch
from ..save_load.jobs import Job, mark, save_job
from ..utils.print_log import EpochOutput
from ..utils.signaling import SIGHandler
from .device_data import DeviceDataset, epoch_permutation
from .graphs import ScoreGraph, held_graph
from .optimizers import set_learning_rate
from .steps import make_train_step, pull_metrics


def split_validation(dataset: ArrayDataset, validation: int, seed: int):
    """Deterministic validation split (ref cvae.py:2155-2167)."""
    if not validation:
        return dataset, None
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(dataset))
    return dataset.subset(perm[validation:]), dataset.subset(perm[:validation])


def train_model(job: Job,
                trainset: Optional[ArrayDataset] = None,
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
                test_sample_size: int = 0,
                save_dir: Optional[str] = None,
                signal_handler: Optional[SIGHandler] = None,
                outputs: Optional[EpochOutput] = None,
                seed: int = 0,
                train_accuracy: bool = False,
                fine_tuning: bool = False,
                final_test: bool = True,
                final_ood: bool = True,
                metrics_every: int = 0,
                device_data: bool = False,
                mesh=None,
                graphed: Optional[bool] = None) -> Job:
    """Train ``job.state`` in place on the job's device; returns the job.
    Without a trainset, the job's set comes from the registry
    (``get_dataset``), its test split as the testset.  ``device_data``
    feeds the steps from a copy of the training set on the device;
    ``mesh`` trains on a device mesh (module docstring); ``graphed``
    (default: True, but on a mesh over gloo on a card) replays the step
    and the engines' scoring batches as CUDA graphs on the card, False
    runs them eagerly."""
    if trainset is None:
        name = job.training_parameters.get('set') or 'cifar10'
        trainset, ts = get_dataset(name)
        testset = testset if testset is not None else ts
    cfg = job.model_cfg
    state = job.state
    model = state.model
    dev = state.device
    outputs = outputs or EpochOutput()
    signal_handler = signal_handler or _NullSignal()
    # cap for the in-training monitoring evals; the final pass stays full
    # (ref validation_sample_size, cvae.py:2098,2171)
    eval_num_batch = (-(-test_sample_size // test_batch_size)
                      if test_sample_size else None)

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
    ramps = (tuple(warmup), tuple(warmup_gamma), frozen)
    multiprocess = world()[0] > 1
    if multiprocess and mesh is None:
        raise ValueError('multi-process training needs an explicit mesh')
    # the in-training evaluations are mesh-fed in a multi-process run
    eng_mesh = mesh if multiprocess else None
    if mesh is not None:
        job.state = state = ensure_placed(state, mesh)
    step = make_train_step(model, job.opt_cfg, *ramps, mesh=mesh,
                           graphed=graphed)
    device_data = device_data and not data_augmentation and mesh is None
    if device_data:
        dd = DeviceDataset(trainset, device=dev)
        per_epoch = dd.n // batch_size
    else:
        loader = DataLoader(trainset, batch_size, shuffle=True, seed=seed,
                            data_augmentation=data_augmentation,
                            drop_last=True)
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

        if ood_now and testset is not None:
            ood_detection_rates(job, testset, oodsets,
                                batch_size=test_batch_size, epoch=epoch,
                                num_batch=eval_num_batch, outputs=outputs,
                                mesh=eng_mesh, graphed=graphed)
        if full_test and testset is not None and cfg.predict_methods:
            accuracy(job, testset, batch_size=test_batch_size, epoch=epoch,
                     num_batch=eval_num_batch, outputs=outputs,
                     mesh=eng_mesh, graphed=graphed)

        # per-epoch LR decay (ref optimizer.update_lr, optimizers.py:123-127)
        set_learning_rate(state.opt_state, job.opt_cfg.lr_at_epoch(epoch))
        state.epoch = epoch

        t0 = time.time()
        running: Dict[str, float] = {}
        metrics: Dict[str, float] = {}
        batches_run = 0
        me = metrics_every or (1 if dev.type == 'cpu' else 8)
        pending = []
        if device_data:
            perm = epoch_permutation(dd.n, seed or 1, epoch, dev)
            batches = (perm[i * batch_size:(i + 1) * batch_size]
                       for i in range(per_epoch))
            run = lambda st, rows: step.gather(st, dd.x, dd.y, rows)
        else:
            if mesh is not None:
                # every rank runs the same full loader and keeps its rows
                batches = (aligned_global_batch(mesh, x, y)
                           for x, y in loader)
            else:
                batches = ((to_device(x, dev), to_device(y, dev))
                           for x, y in loader)
            run = lambda st, xy: step(st, *xy)
        for i, batch in enumerate(batches):
            state, m = run(state, batch)
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
            vl, vm = _mean_losses(job, validationset, test_batch_size,
                                  epoch, mesh=eng_mesh, graphed=graphed)
            checkpoint['validation_loss'] = vl
            checkpoint['validation_measures'] = vm
        if testset is not None and (
                epoch == epochs - 1
                or (epoch - first_epoch) % full_test_every == full_test_every - 1):
            tl, tm = _mean_losses(job, testset, test_batch_size, epoch,
                                  mesh=eng_mesh, graphed=graphed)
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
        if cfg.predict_methods and final_test:
            accuracy(job, testset, batch_size=test_batch_size,
                     outputs=outputs, mesh=eng_mesh, graphed=graphed)
        if oodsets and final_ood:
            ood_detection_rates(job, testset, oodsets,
                                batch_size=test_batch_size, outputs=outputs,
                                mesh=eng_mesh, graphed=graphed)
        if save_dir:
            save_job(job, save_dir)
    return job


def _mean_loss_graph(job: Job, mesh=None, graphed: bool = True
                     ) -> ScoreGraph:
    """The per-epoch losses' batch (the JAX trainer's ``eval_batch``,
    ``joint_vae_tpu/train/trainer.py:331``): the batch means of every
    loss and measure, with labels, as a scoring graph (``graphed=False``:
    eager); a batch that the caller's mesh scope splits over 'data' has
    its means averaged over the ranks, inside the graph."""
    ref = weakref.ref(job)          # the job holds the graph

    def body(generator, x, y):
        job = ref()
        out = evaluate(job.model, x, y, sigma_state=job.sigma_state,
                       train=False, generator=generator)
        row = {**{'loss/' + k: torch.mean(v) for k, v in out.losses.items()},
               **{'measure/' + k: torch.mean(v)
                  for k, v in out.measures.items()}}
        scope = current_scope()
        return (reduce_over_data(row, mesh) if scope is not None
                and scope.rows else row)
    return ScoreGraph(body, name='mean_losses', graphed=graphed)


def _mean_losses(job: Job, dataset: ArrayDataset, batch_size: int,
                 epoch: int, mesh=None, graphed: Optional[bool] = None):
    """-> (mean per-component losses, mean measures incl. rmse/dB) with
    labels (validation/test history tracking); the latent noise comes from
    a generator seeded with the epoch, and the batch means are pulled from
    the card once.  Each batch replays a scoring graph on the card
    (``graphed=False``: eager), held on the job across epochs and sets
    with its generator (``train/graphs.py::held_graph``): the train step
    moves the parameters and the sigma state in place, which the graph
    reads.  ``mesh``: each batch is fed over 'data'
    (``eval_batch_putters``) and runs in the mesh scope that the global
    batch's size decides (split over 'data', its means averaged over the
    ranks, or whole on every rank)."""
    dev = job.device
    graph, gen = held_graph(job, 'mean_losses',
                            lambda g: _mean_loss_graph(job, mesh, g),
                            seed=epoch, mesh=mesh, graphed=graphed)
    put_x = put_y = lambda a: to_device(a, dev)
    if mesh is not None:
        put_x, put_y = eval_batch_putters(mesh, 1 + len(dataset.shape))
    per_batch = []
    for x, y in DataLoader(dataset, batch_size, shuffle=False):
        with mesh_scope(mesh, rows=rows_split(mesh, len(x))):
            per_batch.append(graph(gen, x=put_x(x), y=put_y(y)))
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
