"""The reference's training steps: the gradient of the batch mean of
``model.train_loss`` by autograd, the prior's scalar variances left out
(they do not train), and Adam as the reference project configures it
(b1 0.9, b2 0.999, eps 1e-8 added to the root of the bias-corrected second
moment, no weight decay, no clipping unless the configuration sets it).
"""

from typing import Dict, List

import torch

from . import model

ADAM_EPS = 1e-8


def adam_steps(W: Dict[str, torch.Tensor], cfg: dict, batches: List[tuple],
               noise: List[torch.Tensor], after_step: int = 0) -> dict:
    """Run one step per (x, y) batch on a copy of the weights ``W``, each
    with its latent noise.  Returns each step's loss, the gradient of the
    first step as the optimizer takes it (clipped where the configuration
    clips) and the weights after step ``after_step`` (0: the last)."""
    opt = cfg['optimizer']
    b1, b2 = opt['betas']
    lr = torch.tensor(opt['lr'], dtype=torch.float32).item()
    clip = opt.get('grad_clipping')
    names = model.trained_names(cfg, W)
    P = {k: v.detach().clone() for k, v in W.items()}
    mu = {k: torch.zeros_like(P[k]) for k in names}
    nu = {k: torch.zeros_like(P[k]) for k in names}
    losses, first_grad, after = [], None, None
    for t, ((x, y), eps) in enumerate(zip(batches, noise), start=1):
        leaves = {k: P[k].requires_grad_(True) for k in names}
        loss = model.train_loss(P, cfg, x, y, eps)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        g = {k: gk.detach() for k, gk in zip(names, grads)}
        if clip:
            norm = torch.sqrt(sum(torch.sum(torch.square(v)) for v in g.values()))
            if norm >= clip:
                g = {k: v * (clip / norm) for k, v in g.items()}
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: v.clone() for k, v in g.items()}
        c1 = float(torch.tensor(1.0 - b1 ** t, dtype=torch.float32))
        c2 = float(torch.tensor(1.0 - b2 ** t, dtype=torch.float32))
        with torch.no_grad():
            for k in names:
                mu[k] = b1 * mu[k] + (1 - b1) * g[k]
                nu[k] = b2 * nu[k] + (1 - b2) * g[k] * g[k]
                u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
                P[k] = (P[k].detach() - lr * u)
        if t == after_step:
            after = {k: v.detach().clone() for k, v in P.items()}
        del loss, grads
    if after is None:
        after = {k: v.detach() for k, v in P.items()}
    return {'losses': losses, 'first_grad': first_grad, 'after': after}
