"""Entropy / divergence helpers (ref utils/mutual_information.py:1-87).

A copy of ``joint_vae_tpu/utils/mutual_information.py`` (numpy only)."""

import numpy as np


def entropy(p, axis=-1, eps=1e-12):
    p = np.asarray(p, np.float64)
    return -np.sum(p * np.log(np.maximum(p, eps)), axis=axis)


def kl_divergence(p, q, axis=-1, eps=1e-12):
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    return np.sum(p * (np.log(np.maximum(p, eps)) - np.log(np.maximum(q, eps))),
                  axis=axis)


def js_divergence(p, q, axis=-1):
    m = 0.5 * (np.asarray(p) + np.asarray(q))
    return 0.5 * kl_divergence(p, m, axis) + 0.5 * kl_divergence(q, m, axis)


def mutual_information(p_joint, eps=1e-12):
    """I(X;Y) from a joint distribution table (A, B)."""
    p = np.asarray(p_joint, np.float64)
    p = p / p.sum()
    px = p.sum(1, keepdims=True)
    py = p.sum(0, keepdims=True)
    return float(np.sum(p * (np.log(np.maximum(p, eps))
                             - np.log(np.maximum(px * py, eps)))))
