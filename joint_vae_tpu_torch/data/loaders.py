"""Whole-array datasets and the seeded batch loader the trainer needs.

Port of part of ``joint_vae_tpu/data/loaders.py``: ``to_float``,
:class:`ArrayDataset` (float32 CHW in [0, 1] or uint8, int labels),
``get_batch`` and :class:`DataLoader`'s numpy path with its hflip and
crop augmentation.  The epoch permutation and the augmentation draws come
from ``np.random.default_rng((seed, epoch))``, so both packages see the
same batches.  The dataset registry (and the metadata a dataset carries
there: classes, held-out classes, companions), the file readers and the
native batcher are not ported yet.
"""

from typing import Sequence

import numpy as np


def to_float(x: np.ndarray) -> np.ndarray:
    """uint8 image arrays -> float32 in [0,1]; float passes through."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x.astype(np.float32) * np.float32(1.0 / 255.0)
    return x


class ArrayDataset:
    """In-memory dataset: data (N, C, H, W) float32 in [0,1] (or uint8,
    converted lazily per batch), targets (N,)."""

    def __init__(self, data: np.ndarray, targets: np.ndarray, name: str):
        if data.ndim != 4:
            raise ValueError('ArrayDataset wants (N, C, H, W) data, got '
                             'shape {}'.format(data.shape))
        if data.dtype == np.uint8:
            self.data = data
        else:
            self.data = np.ascontiguousarray(data, np.float32)
        self.targets = np.ascontiguousarray(targets, np.int32)
        self.name = name

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, i):
        return to_float(self.data[i]), self.targets[i]

    @property
    def shape(self):
        return tuple(self.data.shape[1:])

    def subset(self, indices) -> 'ArrayDataset':
        return ArrayDataset(self.data[indices], self.targets[indices],
                            self.name)


def get_batch(dataset: ArrayDataset, batch_size: int = 100, seed=None):
    """One (shuffled) batch (ref get_batch, utils/torch_load.py:548-570)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(dataset), size=min(batch_size, len(dataset)),
                     replace=False)
    return to_float(dataset.data[idx]), dataset.targets[idx]


class DataLoader:
    """Seeded, epoch-shuffled batch iterator over an ArrayDataset, yielding
    host arrays (x float32, y int32).

    Deterministic per (seed, epoch); optionally applies train-time
    augmentation (hflip / random crop with edge padding of size // 8) on
    the host in one vectorized shot per batch."""

    def __init__(self, dataset: ArrayDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 data_augmentation: Sequence[str] = (),
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.augmentation = list(data_augmentation)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self.epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        self.epoch += 1
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        for i in range(0, stop, bs):
            idx = order[i:i + bs]
            x = to_float(self.dataset.data[idx])
            y = self.dataset.targets[idx]
            if self.augmentation:
                x = self._augment(x, rng)
            yield x, y

    def _augment(self, x: np.ndarray, rng) -> np.ndarray:
        if 'flip' in self.augmentation or 'hflip' in self.augmentation:
            m = rng.random(len(x)) < 0.5
            x = x.copy()
            x[m] = x[m][:, :, :, ::-1]
        if any(a.startswith('crop') for a in self.augmentation):
            n, c, h, w = x.shape
            # ref torch_load.py:409-412: RandomCrop(pad=size//8, mode='edge')
            p = max(h // 8, 1)
            xp = np.pad(x, ((0, 0), (0, 0), (p, p), (p, p)), mode='edge')
            oh = rng.integers(0, 2 * p + 1, size=n)
            ow = rng.integers(0, 2 * p + 1, size=n)
            x = np.stack([xp[i, :, oh[i]:oh[i] + h, ow[i]:ow[i] + w]
                          for i in range(n)])
        return x
