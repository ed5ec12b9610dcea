"""Loss / sample recorders: per-batch score tensors checkpointed to disk.

The port's own copy of ``joint_vae_tpu/save_load/recorders.py`` (ref
``utils/save_load/recorders.py:13-399``): named preallocated numpy buffers
with the batch axis LAST (per-class losses are stored (C, total_n), the
logits (C, total_n) too), appended batch by batch, saved as
``record-<set>.jvr`` (or ``.npz``) under ``samples/<epoch>/`` so that
evaluations are re-analyzed without recompute (the 'recorders' tier of the
evaluation engines).  Files interchange with the JAX package both ways.

Formats, dispatched on extension: ``.jvr`` (the engines' default;
``native_store.py``) and ``.npz``.  The
seeded dataloader replay stores the (seed, epoch) pair instead of torch
RNG state.
"""

import os
import re
from typing import Dict, List, Optional

import numpy as np

from . import native_store


def record_filename(set_name: str, fmt: str = 'jvr') -> str:
    """Canonical record file name for a dataset (ref recorders.py:176
    ``record-{set}.pth`` pattern; here .jvr/.npz)."""
    assert fmt in ('jvr', 'npz'), fmt
    return 'record-{}.{}'.format(set_name, fmt)


def find_record(dir_path: str, set_name: str) -> Optional[str]:
    """Existing record file for a set in either format (newest wins)."""
    cands = [os.path.join(dir_path, 'record-{}.{}'.format(set_name, e))
             for e in ('jvr', 'npz')]
    cands = [p for p in cands if os.path.exists(p)]
    if not cands:
        return None
    return max(cands, key=os.path.getmtime)


class LossRecorder:
    FILE_PATTERN = re.compile(r'record-(?P<set>.+)\.(?:npz|jvr)\Z')

    def __init__(self, batch_size: int, num_batch: int = 0,
                 **tensors: np.ndarray):
        self.batch_size = batch_size
        self._tensors: Dict[str, np.ndarray] = {}
        self._num_batch = num_batch
        self._recorded_batches = 0
        self._seed = None
        self.last_batch_size = batch_size
        if tensors:
            self._create_tensors(num_batch, **tensors)

    # -- buffers ------------------------------------------------------------

    def _create_tensors(self, num_batch: int, **tensors):
        for k, t in tensors.items():
            t = np.asarray(t)
            shape = t.shape[:-1] + (num_batch * self.batch_size,)
            self._tensors[k] = np.zeros(shape, t.dtype)
        self._num_batch = num_batch

    def _grow(self, num_batch: int):
        """Enlarge buffers (ref num_batch growth, recorders.py:274-300)."""
        for k, t in self._tensors.items():
            shape = t.shape[:-1] + (num_batch * self.batch_size,)
            nt = np.zeros(shape, t.dtype)
            nt[..., :t.shape[-1]] = t
            self._tensors[k] = nt
        self._num_batch = num_batch

    def keys(self):
        return self._tensors.keys()

    def __contains__(self, k):
        return k in self._tensors

    def __len__(self):
        return self._recorded_batches

    @property
    def recorded_samples(self) -> int:
        full = max(0, self._recorded_batches - 1) * self.batch_size
        return full + (self.last_batch_size if self._recorded_batches else 0)

    # -- append / get ---------------------------------------------------

    def append_batch(self, **batch: np.ndarray):
        """Append one batch per key; creates/grows buffers as needed
        (ref recorders.py:335-370)."""
        batch = {k: np.asarray(v) for k, v in batch.items()}
        n = next(iter(batch.values())).shape[-1]
        assert n <= self.batch_size
        if not self._tensors:
            self._create_tensors(max(self._num_batch, 1), **batch)
        for k, v in batch.items():
            if k not in self._tensors:
                shape = v.shape[:-1] + (self._num_batch * self.batch_size,)
                self._tensors[k] = np.zeros(shape, v.dtype)
        if self._recorded_batches >= self._num_batch:
            self._grow(max(1, self._num_batch * 2))
        start = self._recorded_batches * self.batch_size
        for k, v in batch.items():
            self._tensors[k][..., start:start + n] = v
        self.last_batch_size = n
        self._recorded_batches += 1

    def get(self, k: str) -> np.ndarray:
        """Full recorded array for key k (trimmed to recorded samples)."""
        return self._tensors[k][..., :self.recorded_samples]

    # -- seeded replay ----------------------------------------------------

    def init_seed_for_dataloader(self, seed: Optional[int] = None):
        """Record the shuffling seed so evaluations replay the same batches
        (ref recorders.py:72-90)."""
        self._seed = seed if seed is not None else int(
            np.random.default_rng().integers(1 << 31))
        return self._seed

    def restore_seed(self):
        return self._seed

    # -- persistence ------------------------------------------------------

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        # store only the recorded region — the doubling _grow leaves
        # untouched capacity that would otherwise ~double file sizes
        nb = self._recorded_batches
        trimmed = {k: t[..., :nb * self.batch_size]
                   if t.shape[-1] >= nb * self.batch_size else t
                   for k, t in self._tensors.items()}
        if path.endswith('.jvr'):
            native_store.write_jvr(path, trimmed, self.batch_size,
                                   self._recorded_batches,
                                   self.last_batch_size, self._seed)
            return
        meta = dict(batch_size=self.batch_size,
                    recorded_batches=self._recorded_batches,
                    last_batch_size=self.last_batch_size,
                    seed=self._seed if self._seed is not None else -1)
        # atomic: a crash mid-savez must not leave a truncated npz that
        # poisons the 'recorders' reuse tier (same pattern as checkpoint.py).
        # The tmp name must not look like a record file ('record-*.npz'),
        # or an orphaned tmp would read as a bogus set (the JAX package's
        # loadall) — hence the leading dot (and .npz suffix so savez
        # doesn't append one)
        d, base = os.path.split(path)
        tmp = os.path.join(d, '.' + base + '.tmp.npz')
        np.savez(tmp, __meta__=np.array(list(meta.items()), dtype=object),
                 **trimmed)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> 'LossRecorder':
        if path.endswith('.jvr'):
            meta, tensors = native_store.read_jvr(path)
            seed = -1 if meta['seed'] is None else meta['seed']
            meta = dict(batch_size=meta['batch_size'],
                        recorded_batches=meta['recorded_batches'],
                        last_batch_size=meta['last_batch_size'], seed=seed)
        else:
            with np.load(path, allow_pickle=True) as z:
                meta = dict(z['__meta__'].tolist())
                tensors = {k: z[k] for k in z.files if k != '__meta__'}
        r = cls(int(meta['batch_size']))
        r._tensors = tensors
        r._num_batch = (next(iter(tensors.values())).shape[-1]
                        // r.batch_size if tensors else 0)
        r._recorded_batches = int(meta['recorded_batches'])
        r.last_batch_size = int(meta['last_batch_size'])
        seed = int(meta['seed'])
        r._seed = None if seed < 0 else seed
        return r

    @classmethod
    def peek(cls, path: str) -> Dict[str, object]:
        """Component names and sample count without reading the tensors
        (the header of a .jvr; the member list of a .npz): what the
        results planner needs."""
        if path.endswith('.jvr'):
            meta = native_store.peek_jvr(path)
            components = meta['components']
            nb, bs = meta['recorded_batches'], meta['batch_size']
            last, seed_v = meta['last_batch_size'], meta['seed']
        else:
            with np.load(path, allow_pickle=True) as z:
                meta = dict(z['__meta__'].tolist())
                components = [k for k in z.files if k != '__meta__']
            nb = int(meta['recorded_batches'])
            bs = int(meta['batch_size'])
            last = int(meta['last_batch_size'])
            seed = int(meta['seed'])
            seed_v = None if seed < 0 else seed
        n = max(0, nb - 1) * bs + (last if nb else 0)
        return {'components': components, 'recorded_samples': n,
                'batch_size': bs, 'seed': seed_v}

    @classmethod
    def loadall(cls, dir_path: str, *sets: str,
                output: str = 'recorders') -> Dict[str, object]:
        """Every record file of a sample dir by set name, loaded, or its
        path with ``output='paths'``; a set recorded in both formats
        resolves to the newer file (ref recorders.py:176-216)."""
        if not os.path.isdir(dir_path):
            return {}
        paths: Dict[str, str] = {}
        for fn in os.listdir(dir_path):
            m = cls.FILE_PATTERN.match(fn)
            if not m:
                continue
            name = m.group('set')
            if sets and name not in sets:
                continue
            p = os.path.join(dir_path, fn)
            if name in paths and os.path.getmtime(paths[name]) >= \
                    os.path.getmtime(p):
                continue
            paths[name] = p
        return {name: p if output == 'paths' else cls.load(p)
                for name, p in paths.items()}

    def merge(self, *others: 'LossRecorder') -> 'LossRecorder':
        """Concatenate recorders along the sample axis (array aggregation,
        ref recorders.py:219-272)."""
        keys = set(self._tensors)
        for o in others:
            keys &= set(o._tensors)
        merged = LossRecorder(self.batch_size)
        arrays = {k: np.concatenate([r.get(k) for r in (self,) + others],
                                    axis=-1) for k in keys}
        n = next(iter(arrays.values())).shape[-1] if arrays else 0
        merged._create_tensors(-(-n // self.batch_size), **{
            k: v[..., :1] for k, v in arrays.items()})
        for k, v in arrays.items():
            merged._tensors[k][..., :n] = v
        merged._recorded_batches = -(-n // self.batch_size)
        merged.last_batch_size = n - (merged._recorded_batches - 1) * self.batch_size
        return merged


class SampleRecorder:
    """First-axis-batched recorder for latent samples / images
    (ref recorders.py:372-399)."""

    def __init__(self, **tensors):
        self._arrays: Dict[str, List[np.ndarray]] = {k: [] for k in tensors}

    def keys(self):
        return self._arrays.keys()

    def __contains__(self, k):
        return k in self._arrays

    def append_batch(self, **batch):
        for k, v in batch.items():
            self._arrays.setdefault(k, []).append(np.asarray(v))

    def get(self, k):
        return np.concatenate(self._arrays[k], axis=0)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        np.savez(path, **{k: self.get(k) for k in self._arrays if self._arrays[k]})

    @classmethod
    def load(cls, path: str) -> 'SampleRecorder':
        r = cls()
        with np.load(path) as z:
            for k in z.files:
                r._arrays[k] = [z[k]]
        return r
