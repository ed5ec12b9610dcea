"""The fine-tuning flow (ref ft/job.py:170-478).

Port of ``joint_vae_tpu/ft/job.py``.  Flow: build the moving set ->
pre-tuning OOD baseline (original prior, records under
``samples/<epoch>/init/``) -> fine-tune loop (train batches paired with
cycling moving-set batches) -> estimated labels from the kl argmin ->
post-tuning OOD with both-prior WIM scores -> misclassification rates.

The latent noise comes from generators on the job's device: the loop's
seeded with ``seed``, the post-tuning evaluation's with ``seed + 10000``
for the test set and ``seed + 10000 + i + 1`` for OOD set ``i`` (the JAX
package folds the same numbers into its key).  The WIM scores and their
ROCs run on the host, over the sets' pulled losses.

``mesh=`` runs the flow on a device mesh, as the trainer does: the state
is placed with the sharding rules, the fine-tune batches are each rank's
rows of the same global batches (the one-process data order), the
evaluations are mesh-fed and gathered on every rank, and rank 0 writes
the files.  A multi-process run needs a mesh.

The fine-tune step is replayed as a CUDA graph on the card (its inputs
copied into the graph's buffers), and so is each both-prior batch of
the post-tuning evaluation (:func:`both_prior_graph`: one draw of the
latent noise for both priors, one graph for every set, its generator
reseeded per set), and each batch of ``record_latents``.
"""

import dataclasses
import logging
import os
import time
import weakref
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.loaders import ArrayDataset, DataLoader
from ..device import DeviceLike, to_device
from ..evals.engines import ood_detection_rates
from ..models.evaluate import evaluate
from ..ops.priors import PriorConfig, build_prior_config, init_prior_arrays
from ..ops.roc import DEFAULT_KEPT_TPR, roc_curve, two_sided_from_method
from ..ops.scores import batch_dist_measures
from ..parallel.mesh import (batch_sharding, ensure_placed, eval_feed,
                             put_global, world)
from ..save_load.checkpoint import is_write_process, save_json
from ..save_load.jobs import Job, load_job, save_job
from ..save_load.recorders import LossRecorder, SampleRecorder, record_filename
from ..train.graphs import ScoreGraph, held_graph
from ..train.optimizers import build_optimizer
from ..train.state import make_generator, named_params
from ..train.steps import graph_mode, pull_metrics
from .wim import (WIM_MISCLASS_METHODS_PER_TYPE, WIM_OOD_METHODS_PER_TYPE,
                  WIMJob, is_wim_method, wim_measures)

WIM_PRIOR_FILE = 'wim_prior.npz'
_LOGITS = '/logits'
EVAL_SEED_OFFSET = 10_000
LATENT_BATCHES = 8


def save_wim_prior(wim: WIMJob, job_dir: str):
    """Persist the frozen alternate-prior arrays next to state.npz, under
    the JAX package's keys (``mean``, ``var_param``), so that either
    package reloads the prior the job was tuned against."""
    if wim.alternate_prior_params is None or not is_write_process():
        return
    np.savez(os.path.join(job_dir, WIM_PRIOR_FILE),
             **{k: v.detach().cpu().numpy()
                for k, v in wim.alternate_prior_params.items()})


def load_wim_job(job_dir: str, device: DeviceLike = None,
                 **alternate_prior) -> WIMJob:
    """Load a trained plain job for WIM tuning: lenient state load + OOD
    results reset (ref FTJob.load, ft/job.py:121-169).

    An already-finetuned WIM job (train_params 'wim' section) reloads its
    alternate prior: the arrays from wim_prior.npz when present, else
    re-derived from the persisted seed with the port's generator (which
    differs from the JAX package's: a warning says so)."""
    job = load_job(job_dir, device=device, strict=False)
    wim = WIMJob(job=job)
    saved = dict(job.training_parameters.get('wim') or {})
    if alternate_prior:
        job.ood_results = {}
        wim.set_alternate_prior(**alternate_prior)
    elif saved.get('distribution'):
        known = tuple(f.name for f in dataclasses.fields(PriorConfig))
        p = {k: saved[k] for k in known if saved.get(k) is not None}
        p.setdefault('dim', job.model_cfg.latent_dim)
        dim = p.pop('dim')
        dist = p.pop('distribution')
        wim.alternate_prior_cfg = build_prior_config(dim, dist, **p)
        wim.ft_params = saved
        prior_path = os.path.join(job_dir, WIM_PRIOR_FILE)
        if os.path.exists(prior_path):
            with np.load(prior_path) as z:
                wim.set_alternate_prior_arrays({k: z[k] for k in z.files})
        else:
            seed = int(saved.get('seed') or 0)
            logging.warning(
                '%s has no %s: the alternate prior is re-derived from seed '
                '%d with numpy, whose arrays differ from the JAX package\'s '
                'for the same seed', job_dir, WIM_PRIOR_FILE, seed)
            wim.set_alternate_prior_arrays(init_prior_arrays(
                wim.alternate_prior_cfg, np.random.default_rng(seed)))
    else:
        job.ood_results = {}
    return wim


def both_prior_graph(wim: WIMJob, mesh=None,
                     graphed: Optional[bool] = None) -> ScoreGraph:
    """The both-prior batch (the JAX flow's ``eval_batch``,
    ``joint_vae_tpu/ft/job.py:101-105``) as a scoring graph: the losses,
    their '@' twins and the sample-mean logits (``graphed=False``:
    eager; ``train/graphs.py::graph_mode`` on a mesh)."""
    job = wim.job

    def body(generator, x):
        _, logits, losses, _ = wim.evaluate_on_both_priors(
            x, sigma_state=job.sigma_state, decode_mean=False,
            generator=generator)
        return {**losses, _LOGITS: logits}
    return ScoreGraph(body, name='both_prior_batch',
                      graphed=graph_mode(graphed, mesh))


def _both_prior_losses(wim: WIMJob, dataset: ArrayDataset, batch_size: int,
                       generator: torch.Generator, mesh=None,
                       graph: Optional[ScoreGraph] = None
                       ) -> Dict[str, np.ndarray]:
    """Full-set losses with their '@' twins, the sample-mean logits and
    the true labels, as host arrays; each batch's outputs (copies of the
    graph's) are kept on the device until the set's end and pulled once
    per key.  ``graph``: :func:`both_prior_graph`, held across sets (made
    here when not given).  ``mesh``: mesh-fed batches, gathered on every
    rank."""
    job = wim.job
    if graph is None:
        graph = both_prior_graph(wim, mesh)
    put, run = eval_feed(mesh, job.device, 1 + len(dataset.shape))
    acc: Dict[str, list] = {}
    logits_l, ys = [], []
    for x, y in DataLoader(dataset, batch_size, shuffle=False):
        xt = put(x)
        losses = run(len(x), lambda: graph(generator, x=xt),
                     lambda k, v: v.ndim - (2 if k == _LOGITS else 1))
        logits = losses.pop(_LOGITS)
        for k, v in losses.items():
            acc.setdefault(k, []).append(v)
        logits_l.append(logits)
        ys.append(np.asarray(y))
    out = {k: torch.cat(v, dim=-1).cpu().numpy() for k, v in acc.items()}
    out['y_true'] = np.concatenate(ys)
    out['logits'] = torch.cat(logits_l, dim=0).float().cpu().numpy()
    return out


def _host(a) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a`` (record arrays may be
    read-only maps)."""
    return torch.from_numpy(np.array(a))


def wim_scores_for_set(wim: WIMJob, losses: Dict[str, np.ndarray],
                       methods: Sequence[str]) -> Dict[str, np.ndarray]:
    """Plain + WIM measures for one set, on the host; estimated labels =
    kl argmin over the class axis (ref ft/job.py:447-455)."""
    cfg = wim.cfg
    y_est = None
    if cfg.losses_per_class and losses['kl'].ndim > 1:
        y_est = torch.from_numpy(np.argmin(losses['kl'], axis=0))
    wm = [m for m in methods if is_wim_method(m)]
    pm = [m for m in methods if not is_wim_method(m)]
    tl = {k: _host(v) for k, v in losses.items()
          if k not in ('y_true', 'logits')}
    out = {}
    if pm:
        out.update({k: v.numpy() for k, v in batch_dist_measures(
            cfg, _host(losses['logits']), tl, pm).items()})
    if wm:
        out.update({k: v.numpy() for k, v in
                    wim_measures(cfg, tl, wm, y_est=y_est).items()})
    return out


def host_roc(ins: np.ndarray, outs: np.ndarray, two_sided=False):
    """The ROC of host scores, on the host (``ops/roc.py``)."""
    return roc_curve(torch.from_numpy(np.asarray(ins)),
                     torch.from_numpy(np.asarray(outs)),
                     kept_tpr=DEFAULT_KEPT_TPR, two_sided=two_sided)


def _latents_graph(job: Job, graphed: bool = True) -> ScoreGraph:
    """``record_latents``' batch (the JAX flow's jitted ``mu_of``): the
    encoder means of an evaluation at L=1, as a scoring graph
    (``graphed=False``: eager)."""
    ref = weakref.ref(job)          # the job holds the graph

    def body(generator, x):
        job = ref()
        return {'mu': evaluate(job.model, x, sigma_state=job.sigma_state,
                               L=1, decode_mean=False,
                               generator=generator).mu}
    return ScoreGraph(body, name='latents_batch', graphed=graphed)


def record_latents(wim: WIMJob, datasets: Sequence[ArrayDataset],
                   batch_size: int, generator: torch.Generator,
                   out_dir: str, mesh=None,
                   graphed: Optional[bool] = None) -> None:
    """SampleRecorder dumps of the encoder means of each set's first
    ``LATENT_BATCHES`` batches, with both priors' centroids as
    auxiliaries: the input of the post-hoc PCA / latent-shift inspection
    (ref ft/__main__.py:209-221 feeding ft/inspection.py).  On the card
    each batch replays a scoring graph (one across the sets, held on the
    job with ``generator``; ``graphed=False``: eager).  ``mesh``: every
    rank runs the mesh-fed forwards and gathers, rank 0 writes."""
    job = wim.job
    graph, generator = held_graph(job, 'latents',
                                  lambda g: _latents_graph(job, g),
                                  generator=generator, mesh=mesh,
                                  graphed=graphed)
    if mesh is not None:
        job.state = ensure_placed(job.state, mesh)
    centroids = job.model.prior()['mean'].detach().float().cpu().numpy()
    alternate = (wim.alternate_prior_params['mean'].float().cpu().numpy()
                 if wim.alternate_prior_params is not None else None)
    for ds in datasets:
        put, run = eval_feed(mesh, job.device, 1 + len(ds.shape))
        rec = SampleRecorder()
        mus, ys = [], []
        for i, (x, y) in enumerate(DataLoader(ds, batch_size, shuffle=False)):
            if i >= LATENT_BATCHES:
                break
            xt = put(x)
            mus.append(run(len(x), lambda: graph(generator, x=xt),
                           lambda k, v: v.ndim - 2)['mu'])
            ys.append(np.asarray(y))
        for mu, y in zip(mus, ys):
            rec.append_batch(mu=mu.float().cpu().numpy(), y=y)
        rec.append_batch(centroids=centroids)
        if alternate is not None:
            rec.append_batch(alternate=alternate)
        if is_write_process():
            rec.save(os.path.join(out_dir, 'sample-{}.npz'.format(ds.name)))


def _ood_entry(epoch, ins: np.ndarray, outs: np.ndarray, method: str) -> dict:
    r = host_roc(ins, outs, two_sided_from_method(method))
    return {
        # 'n' counts the OOD samples (ref cvae.py:1886): the json reuse
        # tier compares it against n_wanted(oodset)
        'epochs': epoch, 'n': int(outs.shape[0]),
        'mean': float(np.mean(outs)), 'std': float(np.std(outs)),
        'auc': float(r['auc']),
        'tpr': [float(t) for t in DEFAULT_KEPT_TPR],
        'fpr': r['fpr'].tolist(),
        'thresholds': r['thresholds_low'].tolist()}


def finetune(wim: WIMJob,
             trainset: ArrayDataset,
             moving_set: ArrayDataset,
             testset: ArrayDataset,
             oodsets: Sequence[ArrayDataset] = (),
             epochs: int = 1,
             alpha: float = 0.1,
             train_size: Optional[int] = None,
             batch_size: int = 64,
             moving_batch_size: Optional[int] = None,
             test_batch_size: int = 256,
             ood_methods: Optional[Sequence[str]] = None,
             save_dir: Optional[str] = None,
             seed: int = 0,
             mesh=None,
             outputs=None,
             graphed: Optional[bool] = None) -> WIMJob:
    """Run the WIM fine-tuning flow on the job's device; updates wim.job
    in place (its model, optimizer, sigma state and results).  ``mesh``:
    the trainer's contract (module docstring).  ``graphed`` (default: True
    but on a mesh over gloo on a card) replays the fine-tune step and each
    both-prior batch as CUDA graphs on the card
    (``WIMJob.make_finetune_step``, :func:`both_prior_graph`), False runs
    them eagerly."""
    cfg = wim.cfg
    assert wim.alternate_prior_cfg is not None, 'set_alternate_prior first'
    moving_batch_size = moving_batch_size or batch_size
    methods = list(ood_methods if ood_methods is not None
                   else WIM_OOD_METHODS_PER_TYPE.get(cfg.type, ['elbo', 'zdist']))
    job = wim.job
    dev = job.device
    epoch0 = job.trained
    multiprocess = world()[0] > 1
    if multiprocess and mesh is None:
        raise ValueError('multi-process fine-tuning needs an explicit mesh')
    # the engines are mesh-fed in a multi-process run (as the trainer's)
    eng_mesh = mesh if multiprocess else None
    put_x = put_y = lambda a: to_device(a, dev)
    if mesh is not None:
        job.state = ensure_placed(job.state, mesh)
        nd = mesh.axis_size('data')
        if batch_size % nd or moving_batch_size % nd:
            raise ValueError(
                'batch sizes ({}, moving {}) must divide the mesh data '
                'axis ({})'.format(batch_size, moving_batch_size, nd))
        # every rank runs the same loaders and keeps its rows
        put_x = lambda a: put_global(np.asarray(a),
                                     batch_sharding(mesh, np.ndim(a)))
        put_y = lambda a: put_global(np.asarray(a), batch_sharding(mesh, 1))
    # a fresh optimizer state from the job's config (ref ft/job.py:279-281)
    tx = build_optimizer(job.opt_cfg)
    state = job.state
    state.opt_state = tx.init(named_params(state.model))

    # ---- pre-tuning baseline into samples/<epoch>/init (ref ft/job.py:302-313)
    if save_dir:
        job.saved_dir = save_dir
        init_dir = os.path.join(save_dir, 'samples', '{:04d}'.format(epoch0),
                                'init')
        os.makedirs(init_dir, exist_ok=True)
        # fresh compute + recorders into init/: the array layer merges these
        # 'pre-' records across jobs (ft/array.py merge_recorders(init=True))
        pre = ood_detection_rates(job, testset, list(oodsets),
                                  batch_size=test_batch_size,
                                  method=[m for m in methods
                                          if not is_wim_method(m)],
                                  update_self_ood=False, recording=True,
                                  record_dir=init_dir,
                                  from_where=('compute',), mesh=eng_mesh,
                                  graphed=graphed)
        save_json(pre, os.path.join(init_dir, 'ood.json'))

    # ---- fine-tune loop (ref ft/job.py:356-424)
    if train_size:
        idx = np.random.default_rng(seed).permutation(len(trainset))[:train_size]
        trainset = trainset.subset(idx)

    train_loader = DataLoader(trainset, batch_size, shuffle=True, seed=seed,
                              drop_last=True)
    moving_loader = DataLoader(moving_set, moving_batch_size, shuffle=True,
                               seed=seed + 1, drop_last=True)
    state.generator = make_generator(dev, seed)
    step = wim.make_finetune_step(alpha, tx=tx, train_L=cfg.latent_sampling,
                                  mesh=mesh, graphed=graphed)

    # metrics pulled in windows on a card, as the trainer does
    me = 1 if dev.type == 'cpu' else 8
    per_epoch = len(train_loader)
    step_i = 0
    for epoch in range(epochs):
        mov_iter = iter(moving_loader)
        pending = []
        running = {}
        t0 = time.time()
        for i, (x, y) in enumerate(train_loader):
            try:
                xm, _ = next(mov_iter)
            except StopIteration:
                mov_iter = iter(moving_loader)
                xm, _ = next(mov_iter)
            state, metrics = step(state, put_x(x), put_y(y), put_x(xm))
            step_i += 1
            pending.append(metrics)
            if len(pending) < me and i != per_epoch - 1:
                continue
            for mts in pull_metrics(pending):
                for kk, v in mts.items():
                    running[kk] = running.get(kk, 0.0) + v
            pending = []
            if outputs is not None:
                mean = {kk: running[kk] / (i + 1) for kk in running}
                outputs.results(i, per_epoch, epoch + 1, epochs,
                                preambule='wim',
                                losses={'total': mean.get('total'),
                                        'in': mean.get('in_total'),
                                        'mix': mean.get('mix_total')},
                                time_per_i=(time.time() - t0) / (i + 1),
                                batch_size=batch_size)
        if step_i == 0:
            raise ValueError(
                'no fine-tuning batches: train set ({} samples) smaller '
                'than the batch size ({})'.format(len(trainset), batch_size))
        logging.info('wim epoch %d: total=%.4f (in=%.4f mix=%.4f)', epoch,
                     running.get('total', float('nan')) / max(per_epoch, 1),
                     running.get('in_total', float('nan')) / max(per_epoch, 1),
                     running.get('mix_total', float('nan')) / max(per_epoch, 1))
    job.training_parameters.setdefault('fine_tuning', []).append(
        {'type': 'wim', 'epochs': epochs, 'alpha': alpha,
         'moving_size': len(moving_set), 'train_size': len(trainset),
         'from_epoch': epoch0})
    job.training_parameters['wim'] = dict(wim.ft_params)

    # ---- post-tuning evaluation with WIM scores (ref ft/job.py:433-477)
    # one graph and one generator for every set, reseeded per set (as a
    # fresh generator of that seed draws), so that the captures carry over
    eval_seed = seed + EVAL_SEED_OFFSET
    graph = both_prior_graph(wim, eng_mesh, graphed)
    gen = make_generator(dev, eval_seed)
    ind_losses = _both_prior_losses(wim, testset, test_batch_size, gen,
                                    mesh=eng_mesh, graph=graph)
    ind_scores = wim_scores_for_set(wim, ind_losses, methods)

    epoch_key = job.trained
    job.ood_results.setdefault(epoch_key, {})
    ood_loss_sets = {}
    for i, ood in enumerate(oodsets):
        ood_losses = _both_prior_losses(wim, ood, test_batch_size,
                                        gen.manual_seed(eval_seed + i + 1),
                                        mesh=eng_mesh, graph=graph)
        ood_loss_sets[ood.name] = ood_losses
        ood_scores = wim_scores_for_set(wim, ood_losses, methods)
        job.ood_results[epoch_key].setdefault(ood.name, {})
        for m in methods:
            job.ood_results[epoch_key][ood.name][m] = _ood_entry(
                epoch_key, ind_scores[m], ood_scores[m], m)

    # ---- misclassification rates with WIM scores on estimated labels
    # (ref ft/job.py:477 + WIM misclass methods softzdist~/zdist~)
    mm = WIM_MISCLASS_METHODS_PER_TYPE.get(cfg.type, [])
    if mm and cfg.losses_per_class and ind_losses['kl'].ndim > 1:
        y_est = np.argmin(ind_losses['kl'], axis=0)
        y_true = ind_losses['y_true']
        correct = y_est == y_true
        missed = ~correct
        if correct.any() and missed.any():
            scores = wim_scores_for_set(wim, ind_losses, mm)
            job.testing.setdefault(epoch_key, {})
            entry = {'n': int(len(y_true)), 'epochs': epoch_key,
                     'accuracy': float(correct.mean()),
                     'sampling': cfg.test_latent_sampling}
            for m in mm:
                v = scores[m]
                r = host_roc(v[correct], v[missed])
                entry[m] = {'auc': float(r['auc']),
                            'tpr': [float(t) for t in DEFAULT_KEPT_TPR],
                            'fpr': r['fpr'].tolist(),
                            'precision': r['precision'].tolist()}
            job.testing[epoch_key]['already'] = entry

    # record files (test and OOD sets) for the array aggregation and the
    # engines' recorder tier
    if save_dir:
        sdir = os.path.join(save_dir, 'samples', '{:04d}'.format(epoch_key))
        for set_name, losses_ in [(testset.name, ind_losses),
                                  *ood_loss_sets.items()]:
            rec = LossRecorder(max(1, int(losses_['y_true'].shape[0])))
            extra = {}
            if cfg.losses_per_class and losses_['kl'].ndim > 1:
                # kl-argmin pseudo-labels so that '~' methods replay from
                # the recorder tier (ref ft/job.py:88 y_est_already)
                extra['y_est_already'] = np.argmin(
                    losses_['kl'], axis=0).astype(np.int32)
            rec.append_batch(**{k: v for k, v in losses_.items()
                                if k != 'logits'},
                             logits=losses_['logits'].T, **extra)
            if is_write_process():
                rec.save(os.path.join(sdir, record_filename(set_name)))
        save_job(job, save_dir)
        save_wim_prior(wim, save_dir)
    return wim
