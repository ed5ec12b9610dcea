"""Image-grid generation and latent inspection (ref module/sample.py).

Port of ``joint_vae_tpu/evals/sample.py``:

- :func:`reconstruction_grid` (ref sample:36-173): rows = [input, mean
  reconstruction, average reconstruction, L sampled reconstructions] for
  test / correct / incorrect / OOD inputs;
- :func:`generation_grid`: decode z drawn from the prior (per-class means
  for conditional priors — pure generation);
- :func:`latent_samples` (ref zsample:176-233): mu / log-var arrays for
  histograms and scatters;
- :func:`save_grid_image`: raw npz, and a PNG when PIL imports.

The evaluations run on the job's device (the correct / incorrect scan's
batches as a CUDA graph held on the job); the noise of ``evaluate`` comes
from a torch generator (or ``eps``), the prior draw of
:func:`generation_grid` from ``numpy.random.default_rng(seed)`` (or
``eps``): JAX's ``random.normal`` has no torch counterpart.
"""

import os
import weakref
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import to_device
from ..models.evaluate import evaluate
from ..ops.scores import predict_after_evaluate
from ..save_load.jobs import Job
from ..train.graphs import ScoreGraph, held_graph
from ..train.state import fold_in, make_generator


def _image_reco(cfg, x_reco: torch.Tensor) -> np.ndarray:
    """Reconstructions as host images: float32, or argmax / 255 (float64,
    as numpy divides) for a categorical output."""
    if cfg.output_distribution == 'categorical':
        return torch.argmax(x_reco, dim=-4).cpu().numpy() / 255.0
    return x_reco.float().cpu().numpy()


def _eval(job: Job, x, generator, **kw):
    dev = job.device
    if generator is None:
        generator = make_generator(dev, 0)
    return evaluate(job.model, to_device(np.asarray(x), dev), None,
                    sigma_state=job.sigma_state, train=False,
                    generator=generator, **kw)


def reconstruction_grid(job: Job, x: np.ndarray, y: Optional[np.ndarray] = None,
                        L: int = 8, generator: Optional[torch.Generator] = None,
                        eps: Optional[torch.Tensor] = None
                        ) -> Dict[str, np.ndarray]:
    """-> dict with 'input' (N,C,H,W), 'mean' (N,...), 'average',
    'samples' (L,N,...); optionally 'correct' mask when y given."""
    cfg = job.model_cfg
    out = _eval(job, x, generator, L=L, eps=eps)
    x_reco = _image_reco(cfg, out.x_reco)
    grid = {'input': np.asarray(x),
            'mean': x_reco[0],
            'average': x_reco[1:].mean(0),
            'samples': x_reco[1:1 + L]}
    if y is not None and cfg.predict_methods:
        y_ = predict_after_evaluate(cfg, out.logits, out.losses,
                                    cfg.predict_methods[0]).cpu().numpy()
        grid['correct'] = y_ == np.asarray(y)
    return grid


def _pred_graph(job: Job, graphed: bool = True) -> ScoreGraph:
    """:func:`select_correct_incorrect`'s batch (the JAX driver's jitted
    ``pred``): the evaluation without the mean sample's decode and the
    first predict method's labels, as a scoring graph (``graphed=False``:
    eager)."""
    cfg = job.model_cfg
    ref = weakref.ref(job)          # the job holds the graph

    def body(generator, x):
        job = ref()
        out = evaluate(job.model, x, None, sigma_state=job.sigma_state,
                       train=False, decode_mean=False, generator=generator)
        return {'pred': predict_after_evaluate(cfg, out.logits, out.losses,
                                               cfg.predict_methods[0])}
    return ScoreGraph(body, name='sample_batch', graphed=graphed)


def select_correct_incorrect(job: Job, dataset, n: int,
                             batch_size: int = 256, seed: int = 3,
                             max_batches: int = 64,
                             graphed: Optional[bool] = None):
    """Scan a dataset until n correctly- and n incorrectly-classified
    inputs are pooled (ref module/sample.py:437-466: the reference walks
    the test loader accumulating both pools before building its 'correct'
    and 'incorrect' grids); batch i draws its noise from
    ``fold_in(seed, i)``.  On the card each batch replays a scoring graph
    held on the job, its generator reseeded per batch (``graphed=False``:
    eager).  -> {'correct': (x, y), 'incorrect': (x, y)} (pools may be
    shorter than n if the set runs out)."""
    from ..data.loaders import DataLoader
    cfg = job.model_cfg
    if not cfg.predict_methods:
        return {}
    pools = {'correct': ([], []), 'incorrect': ([], [])}

    def have(name):
        return sum(len(a) for a in pools[name][0])

    graph, gen = held_graph(job, 'sample', lambda g: _pred_graph(job, g),
                            graphed=graphed)
    loader = DataLoader(dataset, batch_size, shuffle=False)
    for i, (x, y) in enumerate(loader):
        if i >= max_batches or all(have(nm) >= n for nm in pools):
            break
        y_ = graph(gen.manual_seed(fold_in(seed, i)),
                   x=to_device(np.asarray(x), job.device))['pred']
        ok = y_.cpu().numpy() == np.asarray(y)
        for name, m in (('correct', ok), ('incorrect', ~ok)):
            if have(name) < n and m.any():
                pools[name][0].append(np.asarray(x)[m])
                pools[name][1].append(np.asarray(y)[m])
    return {name: (np.concatenate(xs)[:n], np.concatenate(ys)[:n])
            for name, (xs, ys) in pools.items() if xs}


def generation_grid(job: Job, n_per_class: int = 8, seed: int = 1,
                    use_class_means: bool = True,
                    eps: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode z ~ prior; (C or 1, n, C_img, H, W) (ref sample.py:88-140).
    ``eps`` (P, n, K) replaces the standard normal draw."""
    model = job.model
    cfg = model.cfg
    prior_cfg = cfg.prior
    mean = model.prior.mean.detach().cpu().numpy()        # (P, K)
    P = mean.shape[0] if (prior_cfg.conditional and use_class_means) else 1
    K = cfg.latent_dim
    if eps is None:
        eps = np.random.default_rng(seed).standard_normal(
            (P, n_per_class, K)).astype(np.float32)
    eps = np.asarray(eps, np.float32)
    # var_param is the INVERSE scale (ops/priors.py: 1/sigma for scalar/
    # diag, inverse Cholesky T for full; density ~ exp(-||T u||^2 / 2)) —
    # sampling applies its inverse to eps for every var_dim
    vp = model.prior.var_param.detach().cpu().numpy().astype(np.float32)
    if prior_cfg.var_dim == 'scalar':
        inv = np.maximum(np.abs(vp).reshape(-1), 1e-6)
        s = inv[:P] if inv.shape[0] >= P else np.full(P, inv[0])
        u = eps / s[:, None, None]
    elif prior_cfg.var_dim == 'diag':
        d = np.maximum(np.abs(vp).reshape(-1, K), 1e-6)
        d = d[:P] if d.shape[0] >= P else np.broadcast_to(d[0], (P, K))
        u = eps / d[:, None, :]
    else:                                      # full: u = T^{-1} eps
        t = np.tril(vp.reshape(-1, K, K))
        t = t[:P] if t.shape[0] >= P else np.broadcast_to(t[0], (P, K, K))
        u = np.stack([np.linalg.solve(t[p], eps[p].T).T for p in range(P)])
    z = torch.from_numpy(np.ascontiguousarray(mean[:P, None] + u))
    with torch.no_grad():
        x = model.decode(z.reshape(-1, K).to(job.device))
    x = _image_reco(cfg, x)
    return x.reshape(P, n_per_class, *x.shape[1:])


def latent_samples(job: Job, x: np.ndarray,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None):
    """mu, log_var, z for latent histograms/scatters (ref zsample)."""
    out = _eval(job, x, generator if generator is not None
                else make_generator(job.device, 2), L=1, eps=eps)
    return tuple(t.float().cpu().numpy() for t in (out.mu, out.log_var, out.z))


def compare_reconstructions(jobs: Sequence[Job], x: np.ndarray,
                            seed: int = 0):
    """Cross-model reconstruction comparison (ref module/sample.py
    'comparison' mode): pairwise MSE matrix between the mean
    reconstructions of several models on the same inputs, plus the
    (M, N, C, H, W) mean-reconstruction rows for side-by-side grids.
    Job i draws its noise from ``fold_in(seed, i)``."""
    recos = []
    for i, job in enumerate(jobs):
        out = _eval(job, x, make_generator(job.device, fold_in(seed, i)), L=1)
        recos.append(_image_reco(job.model_cfg, out.x_reco)[0])
    M = len(jobs)
    d = np.zeros((M, M))
    flat = [r.reshape(len(x), -1) for r in recos]
    for i in range(M):
        for j in range(M):
            d[i, j] = float(np.mean((flat[i] - flat[j]) ** 2))
    return d, np.stack(recos)


def tile_images(rows: Sequence[np.ndarray], pad: int = 2) -> np.ndarray:
    """Stack rows of (N, C, H, W) images into one (H', W', C) uint8 canvas."""
    tiles = []
    for r in rows:
        r = np.clip(np.asarray(r), 0, 1)
        n, c, h, w = r.shape
        row = np.ones((c, h, n * (w + pad))) * 1.0
        for i in range(n):
            row[:, :, i * (w + pad):i * (w + pad) + w] = r[i]
        tiles.append(row)
    c = tiles[0].shape[0]
    h = sum(t.shape[1] + pad for t in tiles)
    w = max(t.shape[2] for t in tiles)
    canvas = np.ones((c, h, w))
    off = 0
    for t in tiles:
        canvas[:, off:off + t.shape[1], :t.shape[2]] = t
        off += t.shape[1] + pad
    img = (canvas.transpose(1, 2, 0) * 255).astype(np.uint8)
    return img.squeeze(-1) if img.shape[-1] == 1 else img


def save_png(rows: Sequence[np.ndarray], path: str) -> bool:
    """The tiled rows as a PNG at ``path`` when PIL imports; False
    without PIL."""
    try:
        from PIL import Image
    except ImportError:
        return False
    Image.fromarray(tile_images(rows)).save(path)
    return True


def save_grid_image(grid: Dict[str, np.ndarray], path: str,
                    max_rows: int = 6):
    """npz always; PNG when PIL is available."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.savez(path + '.npz', **{k: v for k, v in grid.items()})
    rows = [grid['input'], grid['mean'], grid['average']]
    rows += [grid['samples'][i] for i in range(min(len(grid['samples']),
                                                   max_rows - 3))]
    save_png(rows, path + '.png')
