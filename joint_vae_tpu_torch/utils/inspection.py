"""Latent-distribution exporters (ref utils/inspection.py:77-311):
histograms of posterior variances, mu/sigma scatters, per-class latent
means — written as whitespace .dat files for plotting; PCA, an exact
t-SNE, the 2D projection CSV and the latent-shift summary of WIM
fine-tuning.  A copy of ``joint_vae_tpu/utils/inspection.py`` (numpy; its
files equal the JAX package's byte for byte)."""

import csv
import os
from typing import Dict, Optional

import numpy as np


def _write_var_hist(var: np.ndarray, path: str, bins: int):
    """Histogram of the per-dim mean posterior variance (ref
    output_latent_distribution 'hist_of_var' with per_dim=True)."""
    data = var.mean(0)                        # (K,) mean variance per dim
    hist, edges = np.histogram(data, range=(0, float(data.max() or 1.0)),
                               bins=bins)
    np.savetxt(path, np.column_stack([edges[:-1], edges[1:], hist]),
               header='low high count', fmt='%.6g')


def _write_mu_var_scatter(mu: np.ndarray, var: np.ndarray, path: str):
    """Per-dim scatter columns (ref 'scatter' with per_dim=True): one row
    per latent dim with batch statistics mu2_mu (E[mu^2]), mu_var (E[var]),
    mu2 (their sum = E[z^2]), mu_mu (E[mu]) and std_var (sd of var)."""
    mu2_mu = np.mean(mu ** 2, axis=0)
    mu_var = np.mean(var, axis=0)
    cols = np.column_stack([mu2_mu, mu_var, mu2_mu + mu_var,
                            np.mean(mu, axis=0), np.std(var, axis=0)])
    order = np.argsort(-mu2_mu)
    np.savetxt(path, cols[order],
               header='mu2_mu_z mu_var_z mu2_z mu_mu_z std_var_z',
               fmt='%.6g')


def export_latent_histograms(mu: np.ndarray, log_var: np.ndarray,
                             out_dir: str, bins: int = 50,
                             y: Optional[np.ndarray] = None) -> Dict[str, str]:
    """Latent posterior exports (ref zsample, module/sample.py:176-233):
    hist-of-var.dat + mu-sigma-scatter.dat over the whole batch, the same
    pair per class (hist-of-var-<c>.dat ... — the reference's per-class
    'coloring' is one .dat per class), and class-means.dat."""
    os.makedirs(out_dir, exist_ok=True)
    out = {}

    mu = np.asarray(mu, np.float64).reshape(-1, np.shape(mu)[-1])
    var = np.exp(np.asarray(log_var, np.float64)).reshape(mu.shape)

    p = os.path.join(out_dir, 'hist-of-var.dat')
    _write_var_hist(var, p, bins)
    out['hist_of_var'] = p

    p = os.path.join(out_dir, 'mu-sigma-scatter.dat')
    _write_mu_var_scatter(mu, var, p)
    out['mu_sigma_scatter'] = p

    if y is not None:
        y = np.asarray(y).ravel()[:len(mu)]
        for c in range(int(y.max()) + 1):
            i = y == c
            if not i.any():
                continue
            p = os.path.join(out_dir, 'hist-of-var-{}.dat'.format(c))
            _write_var_hist(var[i], p, bins)
            out['hist_of_var_{}'.format(c)] = p
            p = os.path.join(out_dir, 'mu-sigma-scatter-{}.dat'.format(c))
            _write_mu_var_scatter(mu[i], var[i], p)
            out['mu_sigma_scatter_{}'.format(c)] = p
        means = np.stack([mu[y == c].mean(0) if (y == c).any()
                          else np.zeros(mu.shape[-1])
                          for c in range(int(y.max()) + 1)])
        p = os.path.join(out_dir, 'class-means.dat')
        np.savetxt(p, means, fmt='%.6g')
        out['class_means'] = p
    return out


def latent_pca(mu: np.ndarray, n_components: int = 2):
    """Plain-numpy PCA of latent means (ref ft/inspection.py PCA use).
    Returns (projected, components, explained_variance_ratio)."""
    x = np.asarray(mu, np.float64).reshape(-1, mu.shape[-1])
    x = x - x.mean(0)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[:n_components].T
    evr = (s ** 2) / np.sum(s ** 2)
    return proj, vt[:n_components], evr[:n_components]


def _perplexity_affinities(d2: np.ndarray, perplexity: float,
                           tol: float = 1e-5, max_iter: int = 50):
    """Row-conditional gaussian affinities P(j|i) with per-row bandwidths
    binary-searched so each row's perplexity matches the target (the
    standard t-SNE calibration)."""
    n = d2.shape[0]
    target = np.log(perplexity)
    P = np.zeros_like(d2)
    for i in range(n):
        lo, hi, beta = -np.inf, np.inf, 1.0
        di = np.delete(d2[i], i)
        for _ in range(max_iter):
            e = np.exp(-di * beta)
            s = e.sum()
            if s <= 0:
                h = 0.0
                p = np.zeros_like(di)
            else:
                p = e / s
                h = float(-np.sum(p * np.log(np.maximum(p, 1e-30))))
            if abs(h - target) < tol:
                break
            if h > target:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        P[i] = np.insert(p, i, 0.0)
    return P


def latent_tsne(x: np.ndarray, n_components: int = 2,
                perplexity: float = 30.0, n_iter: int = 400,
                learning_rate: float = 100.0) -> np.ndarray:
    """Exact t-SNE of latent means, pure numpy and deterministic
    (PCA init) — the reference's default latent-visualization model
    (ref ft/inspection.py:19,101,218 uses sklearn TSNE(2)).

    Exact (O(N^2)) is the right tradeoff here: inspection inputs are a few
    hundred points (proj2d assembles ~N*sets + centroid replicas)."""
    x = np.asarray(x, np.float64).reshape(len(x), -1)
    n = len(x)
    if n <= n_components + 1:
        return latent_pca(x, n_components)[0]
    perplexity = max(2.0, min(perplexity, (n - 1) / 3))
    d2 = np.square(x[:, None] - x[None]).sum(-1)
    P = _perplexity_affinities(d2, perplexity)
    P = (P + P.T) / (2.0 * n)
    P = np.maximum(P, 1e-12)

    y = latent_pca(x, n_components)[0]
    y = y / (y[:, 0].std() or 1.0) * 1e-4
    inc, gains = np.zeros_like(y), np.ones_like(y)
    exaggeration_until = n_iter // 3
    Pex = P * 12.0
    for it in range(n_iter):
        p = Pex if it < exaggeration_until else P
        num = 1.0 / (1.0 + np.square(y[:, None] - y[None]).sum(-1))
        np.fill_diagonal(num, 0.0)
        Q = np.maximum(num / num.sum(), 1e-12)
        W = (p - Q) * num
        grad = 4.0 * ((np.diag(W.sum(1)) - W) @ y)
        momentum = 0.5 if it < exaggeration_until else 0.8
        gains = np.where(np.sign(grad) != np.sign(inc),
                         gains + 0.2, gains * 0.8).clip(0.01)
        inc = momentum * inc - learning_rate * gains * grad
        y = y + inc
        y = y - y.mean(0)
    return y


PROJ2D_MODELS = {'pca': lambda x: latent_pca(x, 2)[0],
                 'tsne': latent_tsne}


def proj2d_csv(pre: Dict[str, Dict[str, np.ndarray]],
               post: Dict[str, Dict[str, np.ndarray]],
               tset: str, classes, csv_file: str,
               model: str = 'tsne', N: int = 60,
               include_alternate: bool = True) -> Dict[str, np.ndarray]:
    """2D projection of pre/post latent dumps -> the reference's proj2d
    CSV (columns x1,x2,y,set,dist,ft — ref ft/inspection.py:100-180).

    ``pre``/``post`` map set name -> {'mu': (N,K) [, 'y': (N,)]}, with the
    in-distribution entry also carrying 'centroids' (C,K) and optionally
    'alternate' (1,K) (the aux arrays record_latents stores).  Rows:
    per-class prior centroids (ft='both'), the alternate prior mean
    (set='alt'), and up to N ind / N//10 ood points per phase.
    """
    assert model in PROJ2D_MODELS, model
    centroids = np.asarray(pre[tset]['centroids'], np.float64)
    alt = pre[tset].get('alternate')
    blocks, rows = [centroids], [('centroids', None)]
    if include_alternate and alt is not None:
        blocks.append(np.asarray(alt, np.float64).reshape(1, -1))
        rows.append(('alternate', None))
    for recs, suffix in ((pre, 'pre'), (post, 'ft')):
        for name, r in recs.items():
            n = N if name == tset else max(1, N // 10)
            mu = np.asarray(r['mu'], np.float64)[:n]
            blocks.append(mu)
            y = np.asarray(r['y'])[:len(mu)] if name == tset and 'y' in r \
                else None
            rows.append(('{}-{}'.format(name, suffix), y))

    proj = PROJ2D_MODELS[model](np.vstack(blocks))

    out: Dict[str, np.ndarray] = {}
    os.makedirs(os.path.dirname(csv_file) or '.', exist_ok=True)
    with open(csv_file, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['x1', 'x2', 'y', 'set', 'dist', 'ft'])
        start = 0
        for (key, y), block in zip(rows, blocks):
            seg = proj[start:start + len(block)]
            start += len(block)
            out[key] = seg
            if key == 'centroids':
                labels, dset, dist, ft = list(classes), 'centroids', 'ind', 'both'
            elif key == 'alternate':
                labels, dset, dist, ft = ['ood'], 'alt', 'ood', 'both'
            else:
                dset, ft = key.rsplit('-', 1)
                dist = 'ind' if dset == tset else 'ood'
                labels = ([classes[int(c)] for c in y] if y is not None
                          else [dset] * len(seg))
            for (x1, x2), lab in zip(seg, labels):
                writer.writerow(['{:.6g}'.format(x1), '{:.6g}'.format(x2),
                                 lab, dset, dist, ft])
    return out


def latent_shift(mu_before: np.ndarray, mu_after: np.ndarray) -> Dict[str, float]:
    """Summary of the latent drift induced by fine-tuning
    (ref ft/inspection.py latent-shift analysis)."""
    a = np.asarray(mu_before, np.float64).reshape(-1, mu_before.shape[-1])
    b = np.asarray(mu_after, np.float64).reshape(-1, mu_after.shape[-1])
    n = min(len(a), len(b))
    d = b[:n] - a[:n]
    return {'mean_shift': float(np.linalg.norm(d.mean(0))),
            'mean_norm': float(np.linalg.norm(d, axis=1).mean()),
            'max_norm': float(np.linalg.norm(d, axis=1).max())}
