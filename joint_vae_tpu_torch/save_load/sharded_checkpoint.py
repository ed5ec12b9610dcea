"""Sharded checkpoints: per-rank shard files and a manifest, written
synchronously or on a worker thread, and stitched back in numpy.

Port of ``joint_vae_tpu/save_load/sharded_checkpoint.py``.  A sharded
checkpoint is a directory::

    <stem>.shards/
      manifest.json      {'format': 'jvt-sharded-v1', 'process_count',
                          'leaves': {path: {'shape', 'dtype'}}}, rank 0's
      shard-<p>.npz      the chunks rank p wrote, keyed
                         '<tree path>@<offset0>,<offset1>,...'

- **One writer per chunk.** A leaf split over 'model' is written by the
  rank at 'data' (and 'sample') index 0 of each model column, its chunk at
  that column's offset; every other leaf by rank 0.  No collective runs
  in a write.
- **bfloat16** leaves are stored as their uint16 words; the manifest keeps
  the true dtype.
- **Asynchronous writes** (:class:`AsyncCheckpointer`): the submit
  snapshots every chunk with an on-device ``clone()`` (the optimizer
  updates the parameters in place) and returns; the device->host copies
  and the file IO then run on a worker thread while the caller goes on.
  A job's save submits its state, its optimizer and the removal of the
  other format as one write (``jobs.py::save_job``).

:func:`load_checkpoint_sharded` stitches the chunks back into one global
array per tree path, whatever mesh wrote them, so a checkpoint restores
onto another mesh shape (the caller places the full arrays on its mesh).
"""

import dataclasses
import json
import os
import tempfile
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

MANIFEST = 'manifest.json'


FORMAT = 'jvt-sharded-v1'


@dataclasses.dataclass
class Leaf:
    """One tree path's value on this rank: ``value`` (this rank's block
    when ``axis`` is set, in the port's layout), ``to_jax`` its layout
    conversion, and ``axis`` the JAX-layout axis split over 'model'."""
    value: object
    to_jax: Optional[Callable] = None
    axis: Optional[int] = None


def _chunk_key(path: str, offsets) -> str:
    return '{}@{}'.format(path, ','.join(str(int(o)) for o in offsets))


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


def _host(value, to_jax) -> np.ndarray:
    """A chunk in the JAX layout as a storable host array: bfloat16 as
    its uint16 words."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if to_jax is not None:
            t = to_jax(t)
        t = t.contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(value)


def _dtype_name(value) -> str:
    if isinstance(value, torch.Tensor):
        return str(value.dtype).replace('torch.', '')
    return np.asarray(value).dtype.name


def _local_chunks(leaves: Dict[str, Leaf], mesh=None):
    """-> (chunks this rank writes {key: (value, to_jax)}, manifest leaf
    entries).  The host copies are left to the writer."""
    rank = mesh.rank if mesh is not None else 0
    m = mesh.axis_size('model') if mesh is not None else 1
    col = mesh.index('model') if mesh is not None else 0
    lead = mesh is None or (mesh.index('data') == 0
                            and mesh.index('sample') == 0)
    chunks, entries = {}, {}
    for path, leaf in leaves.items():
        v = leaf.value
        shape = list(v.shape if isinstance(v, torch.Tensor)
                     else np.shape(v))
        if leaf.to_jax is not None:
            shape = list(leaf.to_jax(torch.empty(shape, device='meta')).shape)
        offs = [0] * len(shape)
        if leaf.axis is not None and m > 1:
            offs[leaf.axis] = col * shape[leaf.axis]
            shape[leaf.axis] *= m
            mine = lead
        else:
            mine = rank == 0
        entries[path] = {'shape': shape, 'dtype': _dtype_name(v)}
        if mine:
            chunks[_chunk_key(path, offs)] = (v, leaf.to_jax)
    return chunks, entries


def _write_npz(path: str, arrays: Dict[str, np.ndarray]):
    d = os.path.dirname(path) or '.'
    fd, tmp = tempfile.mkstemp(dir=d, suffix='.npz')
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def barrier():
    """Every rank waits until all shard files exist (a no-op alone)."""
    from ..parallel.mesh import barrier as mesh_barrier
    mesh_barrier()


def sharded_write(dir_path: str, leaves: Dict[str, Leaf], mesh=None,
                  snapshot: bool = False) -> Callable[[], None]:
    """The write of ``leaves`` as ``<dir>/shard-<rank>.npz`` and rank 0's
    ``manifest.json``, as a call that takes no argument.  ``snapshot``
    copies this rank's chunks now, on the device, so that the call may
    run later, on a worker thread, while the optimizer updates the live
    tensors in place."""
    os.makedirs(dir_path, exist_ok=True)
    chunks, entries = _local_chunks(leaves, mesh)
    rank = mesh.rank if mesh is not None else 0
    size = mesh.size if mesh is not None else 1
    shard_path = os.path.join(dir_path, 'shard-{}.npz'.format(rank))
    manifest = {'format': FORMAT, 'process_count': size, 'leaves': entries}
    if snapshot:
        chunks = {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                      else np.array(v), f)
                  for k, (v, f) in chunks.items()}

    def write():
        _write_npz(shard_path, {k: _host(v, f)
                                for k, (v, f) in chunks.items()})
        if rank == 0:
            fd, tmp = tempfile.mkstemp(dir=dir_path, suffix='.tmp')
            with os.fdopen(fd, 'w') as f:
                json.dump(manifest, f, indent=1)
            os.replace(tmp, os.path.join(dir_path, MANIFEST))
    return write


def save_checkpoint_sharded(dir_path: str, leaves: Dict[str, Leaf],
                            mesh=None,
                            checkpointer: Optional['AsyncCheckpointer'] = None,
                            sync: bool = True):
    """Write ``leaves`` (:func:`sharded_write`).  ``checkpointer`` runs
    the host copies and the file IO on its worker thread after an
    on-device snapshot; ``sync=False`` skips the closing barrier (the
    caller then waits on the checkpointer and calls :func:`barrier`
    before any rank loads)."""
    write = sharded_write(dir_path, leaves, mesh,
                          snapshot=checkpointer is not None)
    if checkpointer is not None:
        checkpointer.submit(write)
        if sync:
            checkpointer.wait()
    else:
        write()
    if sync:
        barrier()


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


class AsyncCheckpointer:
    """One background writer; ``submit`` waits for the previous write
    first (at most one checkpoint's host copies in flight).  An exception
    of the worker re-raises on the next ``wait``/``submit``, so that a
    failed save cannot pass silently."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]):
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:   # re-raised on wait()
                self._exc = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name='jvt-ckpt-writer')
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            e, self._exc = self._exc, None
            raise e
