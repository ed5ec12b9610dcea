"""Checkpoint primitives: atomic JSON and npz archives, with no JAX.

Port of ``joint_vae_tpu/save_load/checkpoint.py``: the job's JSON files
keep their names and schemas; ``state.npz`` holds arrays keyed by their
tree paths (``params/encoder/dense_mean/kernel``...).
"""

import json
import os
import tempfile
from typing import Any, Dict

import numpy as np


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, 'item'):
        return o.item()
    raise TypeError('not JSON serializable: {}'.format(type(o)))


def save_json(d: Dict[str, Any], path: str, indent: int = 1):
    """Atomic JSON write (temp file + rename)."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or '.', suffix='.tmp')
    try:
        with os.fdopen(fd, 'w') as f:
            json.dump(d, f, indent=indent, default=_json_default)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_json(path: str):
    """JSON load converting integer-string keys back to ints (results are
    keyed by epoch)."""
    with open(path) as f:
        d = json.load(f)

    def intify(x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                try:
                    k = int(k)
                except (ValueError, TypeError):
                    pass
                out[k] = intify(v)
            return out
        return x
    return intify(d)


def save_arrays(path: str, arrays: Dict[str, np.ndarray]):
    """Save {key: array} to a .npz (atomic)."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or '.', suffix='.npz')
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
