"""Poscod: post-hoc OOD head on the frozen latent space
(ref ft/poscod.py:11-207).

Port of ``joint_vae_tpu/ft/poscod.py``.  The whole net is frozen; a
single-logit linear head on the encoder mean is trained with Adam on the
binary cross-entropy to tell in-distribution inputs (label 1) from the
moving set (label 0).  The score is the head's output, the
log-likelihood ratio ('llr' method).  The head's optimizer is the port's
Adam (``train/optimizers.py``), optax's ``adam`` step for step.

On the card the frozen net's batches replay a scoring graph held on the
job (its means, and with the head its scores: one replay per scored
batch) and the head's step a step graph, its head and Adam's moments
updated in place (``train/graphs.py``).

``mesh=``: the frozen net's forwards are mesh-fed and their encoder means
gathered, so that every rank trains the same replicated head (K+1
scalars) on the whole batch, as one process does (eagerly).
"""

import dataclasses
import os
import weakref
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.loaders import ArrayDataset, DataLoader
from ..device import DeviceLike
from ..models.evaluate import evaluate
from ..parallel.mesh import ensure_placed, eval_feed, world
from ..save_load.checkpoint import is_write_process
from ..save_load.jobs import Job, load_job
from ..train.graphs import ScoreGraph, StepGraph, graph_mode, held_graph
from ..train.optimizers import (OptimizerConfig, advance_counts,
                                build_optimizer, sync_device_scalars)

OOD_METHODS = ['llr']

#: trained head weights next to state.npz: without them a reloaded poscod
#: job could not re-score 'llr' on new data (ref keeps the head inside
#: state.pth as ood_head.1.*, ft/poscod.py:38-42)
POSCOD_HEAD_FILE = 'poscod_head.npz'


def save_poscod_head(pc: 'PoscodJob', job_dir: str):
    if pc.head is None or not is_write_process():
        return
    np.savez(os.path.join(job_dir, POSCOD_HEAD_FILE),
             **{k: v.detach().cpu().numpy() for k, v in pc.head.items()})


def load_poscod_job(job_dir: str, device: DeviceLike = None) -> 'PoscodJob':
    """Reload a poscod job: the llr head comes back from poscod_head.npz
    when present (ref PoscodJob.load reloads ood_head from state.pth)."""
    pc = PoscodJob(job=load_job(job_dir, device=device))
    path = os.path.join(job_dir, POSCOD_HEAD_FILE)
    if os.path.exists(path):
        dev = pc.job.device
        with np.load(path) as z:
            pc.head = {k: torch.as_tensor(z[k], device=dev) for k in ('w', 'b')}
    return pc


def _mu_graph(job: Job, graphed: bool = True) -> ScoreGraph:
    """Poscod's batch (the JAX ``_mu_jit`` and ``score``): the encoder
    means of the whole model's forward, widened to float32 (as JAX
    promotes a bfloat16 model's against the float32 head), and with the
    head's ``w`` and ``b`` given, its scores ``mu @ w + b`` instead; as
    a scoring graph (``graphed=False``: eager)."""
    ref = weakref.ref(job)          # the job holds the graph

    def body(generator, x, w=None, b=None):
        job = ref()
        mu = evaluate(job.model, x, None, sigma_state=job.sigma_state,
                      train=False, L=1, compute_iws=False, decode_mean=False,
                      generator=generator).mu.float()
        if w is None:
            return {'mu': mu}
        return {'llr': mu @ w + b}
    return ScoreGraph(body, name='poscod_batch', graphed=graphed)


class _HeadStep:
    """The head's step (the JAX ``step``): the BCE of ``mu @ w + b``
    against ind = 1, moving = 0 and the Adam update, the head and the
    moments updated in place and Adam's count read from a device scalar,
    as a step graph (``graphed=False``: eager)."""

    generator = None                # the step draws no noise

    def __init__(self, K: int, lr: float, device, graphed: bool):
        self.head = {'w': torch.zeros((K,), device=device),
                     'b': torch.zeros((), device=device)}
        self.tx = build_optimizer(OptimizerConfig(optim_type='adam', lr=lr))
        self.opt_state = self.tx.init(self.head)
        self.device = device
        self.graph = StepGraph(self._body, name='poscod_head_step',
                               graphed=graphed)

    def _body(self, state, mu_i: torch.Tensor, mu_m: torch.Tensor) -> dict:
        mu = torch.cat([mu_i, mu_m])
        labels = torch.cat([torch.ones(len(mu_i), device=mu.device),
                            torch.zeros(len(mu_m), device=mu.device)])
        leaves = {k: v.detach().requires_grad_() for k, v in self.head.items()}
        with torch.enable_grad():
            logit = mu @ leaves['w'] + leaves['b']
            loss = F.binary_cross_entropy_with_logits(logit, labels)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        updates, _ = self.tx.update(grads, self.opt_state, self.head,
                                    capturable=True)
        with torch.no_grad():
            torch._foreach_add_(list(self.head.values()),
                                [updates[k] for k in self.head])
        return {'loss': loss.detach()}

    def __call__(self, mu_i: torch.Tensor, mu_m: torch.Tensor) -> None:
        sync_device_scalars(self.opt_state, self.device)
        self.graph(self, owner=(self.opt_state,), mu_i=mu_i, mu_m=mu_m)
        advance_counts(self.opt_state, adam=True)


@dataclasses.dataclass
class PoscodJob:
    """``graphed`` (default: True but on a mesh over gloo on a card,
    ``train/graphs.py::graph_mode``) replays the frozen net's
    batches (its means, and with the head its scores) as a scoring graph
    held on the job, shared by :meth:`finetune` and :meth:`llr_scores`
    (each reseeds its generator), and the head's step as a step graph;
    False runs both eagerly."""
    job: Job
    head: Optional[Dict[str, torch.Tensor]] = None
    graphed: Optional[bool] = None

    def _batches(self, dataset: ArrayDataset, seed: int, mesh):
        """(put, run, graph, generator) of a pass over ``dataset``."""
        job = self.job
        graph, gen = held_graph(job, 'poscod', lambda g: _mu_graph(job, g),
                                seed=seed, mesh=mesh, graphed=self.graphed)
        if mesh is not None:
            job.state = ensure_placed(job.state, mesh)
        put, run = eval_feed(mesh, job.device, 1 + len(dataset.shape))
        return put, run, graph, gen

    @staticmethod
    def _check(mesh):
        if world()[0] > 1 and mesh is None:
            raise ValueError('multi-process poscod needs an explicit mesh')

    def finetune(self, ind: ArrayDataset, moving: ArrayDataset,
                 epochs: int = 5, batch_size: int = 128, lr: float = 1e-3,
                 seed: int = 0, mesh=None):
        """Train the 1-logit head with BCE (ind = 1, moving = 0)."""
        self._check(mesh)
        dev = self.job.device
        put, run, graph, gen = self._batches(ind, seed, mesh)

        def mu(x):
            xt = put(x)
            m = run(len(x), lambda: graph(gen, x=xt),
                    lambda k, v: v.ndim - 2)['mu']
            return m.reshape((-1, m.shape[-1])) if m.ndim > 2 else m
        step = _HeadStep(self.job.model_cfg.latent_dim, lr, dev,
                         graph_mode(self.graphed, mesh))
        for epoch in range(epochs):
            li = DataLoader(ind, batch_size, seed=seed + epoch)
            lm = DataLoader(moving, batch_size, seed=seed + epoch + 1)
            for (xi, _), (xm, _) in zip(li, lm):
                step(mu(xi), mu(xm))
        self.head = step.head
        return self

    def llr_scores(self, dataset: ArrayDataset, batch_size: int = 256,
                   seed: int = 0, mesh=None) -> np.ndarray:
        assert self.head is not None, 'finetune first'
        self._check(mesh)
        put, run, graph, gen = self._batches(dataset, seed, mesh)
        out = []
        for x, _ in DataLoader(dataset, batch_size, shuffle=False):
            xt = put(x)
            s = run(len(x), lambda: graph(gen, x=xt, **self.head),
                    lambda k, v: v.ndim - 1)['llr']
            out.append(s.reshape(-1))
        return torch.cat(out).cpu().numpy()
