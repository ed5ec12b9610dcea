"""Sharded checkpoints: the reader half, in numpy.

Port of the loading side of ``joint_vae_tpu/save_load/sharded_checkpoint.py``.
A sharded checkpoint is a directory::

    <stem>.shards/
      manifest.json      {'format', 'process_count', 'leaves': {path:
                          {'shape', 'dtype'}}}
      shard-<p>.npz      the chunks process p wrote, keyed
                         '<tree path>@<offset0>,<offset1>,...'

:func:`load_checkpoint_sharded` stitches the chunks back into one global
array per tree path, whatever mesh wrote them.  The writer and the
asynchronous checkpointer belong to the multi-GPU port (ROADMAP Queue 1
item 14).
"""

import json
import os
from typing import Dict

import numpy as np

MANIFEST = 'manifest.json'


def _split_key(key: str):
    path, _, off = key.rpartition('@')
    offsets = tuple(int(o) for o in off.split(',')) if off else ()
    return path, offsets


def _storage_dtype(name: str) -> np.dtype:
    """numpy has no bfloat16: such a leaf is stitched as its raw 16-bit
    words (the shard files store it so) and widened afterwards."""
    return np.dtype(np.uint16) if name == 'bfloat16' else np.dtype(name)


def _widen_bfloat16(words: np.ndarray) -> np.ndarray:
    return (words.astype(np.uint32) << 16).view(np.float32)


def is_sharded_checkpoint(dir_path: str) -> bool:
    return os.path.isfile(os.path.join(dir_path, MANIFEST))


def load_checkpoint_sharded(dir_path: str) -> Dict[str, np.ndarray]:
    """Stitch shard files back into {tree path: global ndarray}; bfloat16
    leaves come back as float32 (exact)."""
    with open(os.path.join(dir_path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves = manifest['leaves']
    out = {k: np.zeros(tuple(e['shape']), _storage_dtype(e['dtype']))
           for k, e in leaves.items()}
    filled = {k: 0 for k in leaves}
    for p in range(manifest['process_count']):
        sp = os.path.join(dir_path, 'shard-{}.npz'.format(p))
        if not os.path.exists(sp):
            raise FileNotFoundError(
                'sharded checkpoint {} is missing {} (incomplete save? '
                'manifest expects {} processes)'.format(
                    dir_path, sp, manifest['process_count']))
        with np.load(sp) as z:
            for key in z.files:
                path, offs = _split_key(key)
                chunk = z[key]
                want = out[path].dtype
                if chunk.dtype != want and chunk.dtype.kind in 'uV':
                    chunk = chunk.view(want)
                sl = tuple(slice(o, o + s)
                           for o, s in zip(offs, chunk.shape))
                out[path][sl] = chunk
                filled[path] += max(chunk.size, 1)
    bad = [k for k, e in leaves.items()
           if filled[k] < max(int(np.prod(e['shape'])), 1)]
    if bad:
        raise ValueError('sharded checkpoint {} has unfilled leaves '
                         '(chunks missing): {}'.format(dir_path, bad[:5]))
    for k, e in leaves.items():
        if e['dtype'] == 'bfloat16':
            out[k] = _widen_bfloat16(out[k])
    return out
