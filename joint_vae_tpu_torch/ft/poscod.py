"""Poscod: post-hoc OOD head on the frozen latent space
(ref ft/poscod.py:11-207).

Port of ``joint_vae_tpu/ft/poscod.py``.  The whole net is frozen; a
single-logit linear head on the encoder mean is trained with Adam on the
binary cross-entropy to tell in-distribution inputs (label 1) from the
moving set (label 0).  The score is the head's output, the
log-likelihood ratio ('llr' method).  The head's optimizer is the port's
Adam (``train/optimizers.py``), optax's ``adam`` step for step.

``mesh=``: the frozen net's forwards are mesh-fed and their encoder means
gathered, so that every rank trains the same replicated head (K+1
scalars) on the whole batch, as one process does.
"""

import dataclasses
import os
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
from ..train.optimizers import OptimizerConfig, build_optimizer
from ..train.state import make_generator

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


@dataclasses.dataclass
class PoscodJob:
    job: Job
    head: Optional[Dict[str, torch.Tensor]] = None

    def _mu(self, x: np.ndarray, generator: torch.Generator,
            mesh=None) -> torch.Tensor:
        """The encoder means (N, K) of a host batch in float32, on the
        job's device (gathered on every rank of a mesh).  A bfloat16
        model's means are widened, as JAX promotes them against the
        float32 head."""
        job = self.job
        if mesh is not None:
            job.state = ensure_placed(job.state, mesh)
        put, run = eval_feed(mesh, job.device, np.ndim(x))
        xt = put(x)

        def forward():
            return {'mu': evaluate(job.model, xt, None,
                                   sigma_state=job.sigma_state, train=False,
                                   L=1, compute_iws=False, decode_mean=False,
                                   generator=generator).mu}
        mu = run(len(x), forward, lambda k, v: v.ndim - 2)['mu'].float()
        return mu.reshape((-1, mu.shape[-1])) if mu.ndim > 2 else mu

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
        K = self.job.model_cfg.latent_dim
        head = {'w': torch.zeros((K,), device=dev),
                'b': torch.zeros((), device=dev)}
        tx = build_optimizer(OptimizerConfig(optim_type='adam', lr=lr))
        opt_state = tx.init(head)
        generator = make_generator(dev, seed)
        for epoch in range(epochs):
            li = DataLoader(ind, batch_size, seed=seed + epoch)
            lm = DataLoader(moving, batch_size, seed=seed + epoch + 1)
            for (xi, _), (xm, _) in zip(li, lm):
                mu = torch.cat([self._mu(xi, generator, mesh),
                                self._mu(xm, generator, mesh)])
                labels = torch.cat([torch.ones(len(xi), device=dev),
                                    torch.zeros(len(xm), device=dev)])
                leaves = {k: v.detach().requires_grad_() for k, v in head.items()}
                with torch.enable_grad():
                    logit = mu @ leaves['w'] + leaves['b']
                    loss = F.binary_cross_entropy_with_logits(logit, labels)
                    grads = dict(zip(leaves, torch.autograd.grad(
                        loss, list(leaves.values()))))
                updates, opt_state = tx.update(grads, opt_state, head)
                head = {k: head[k] + updates[k] for k in head}
        self.head = head
        return self

    def llr_scores(self, dataset: ArrayDataset, batch_size: int = 256,
                   seed: int = 0, mesh=None) -> np.ndarray:
        assert self.head is not None, 'finetune first'
        self._check(mesh)
        generator = make_generator(self.job.device, seed)
        out = [self._mu(x, generator, mesh) @ self.head['w'] + self.head['b']
               for x, _ in DataLoader(dataset, batch_size, shuffle=False)]
        return torch.cat(out).cpu().numpy()
