"""Mesh-fed data: each rank's rows of a global batch.

Port of ``joint_vae_tpu/parallel/sharded_data.py``.  A rank holds the rows
of its 'data' index; the ranks of a model (or sample) group hold the same
rows.  Two ways to feed:

- :func:`aligned_global_batch`: every rank iterates the same full-dataset
  loader (same seed, same permutation, same global batches) and keeps its
  contiguous slice, so the data order is the one-process run's and the
  trajectories compare directly;
- :func:`sharded_loader`: each 'data' index iterates only its own equal
  shard of the dataset (:func:`process_shard`) with a local batch of
  global / data-axis rows.
"""

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.loaders import ArrayDataset, DataLoader
from .mesh import Mesh, batch_sharding, put_global, world


def process_shard(dataset: ArrayDataset,
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> ArrayDataset:
    """The contiguous slice of a dataset that shard ``process_index`` of
    ``process_count`` (default: this rank of the world) is responsible
    for.  Every shard gets exactly
    ``len // count`` items (a shard with one more batch than its peers
    would enter a collective alone and hang it); the remainder is dropped
    like a drop_last batch tail."""
    size, rank = world()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    per = len(dataset) // pc
    lo = pi * per
    return dataset.subset(np.arange(lo, lo + per))


def global_batch(mesh: Mesh, x_local: np.ndarray, y_local: np.ndarray
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows, already cut, on the mesh's device."""
    dev = mesh.device
    return (torch.as_tensor(np.ascontiguousarray(x_local)).to(dev),
            torch.as_tensor(np.ascontiguousarray(y_local)).to(dev))


def aligned_global_batch(mesh: Mesh, x: np.ndarray, y: np.ndarray
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's contiguous slice of a host copy of the full global
    batch.  A batch that does not divide over the 'data' axis raises: the
    one-process data order needs equal contiguous slices."""
    x, y = np.asarray(x), np.asarray(y)
    nd = mesh.axis_size('data')
    if x.shape[0] % nd:
        raise ValueError(
            'global batch of {} rows does not divide over {} processes — '
            'pick a batch size that is a multiple of the process count '
            '(the bit-identical data-order guarantee needs equal '
            'contiguous per-process slices)'.format(x.shape[0], nd))
    return (put_global(x, batch_sharding(mesh, x.ndim)),
            put_global(y, batch_sharding(mesh, 1)))


def sharded_loader(mesh: Mesh, dataset: ArrayDataset, global_batch_size: int,
                   seed: int = 0, shuffle: bool = True,
                   data_augmentation=()
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-epoch iterator of this rank's rows: each 'data' index runs its
    own shard with the same seed, so the global batches stay aligned; the
    local batch is ``global_batch_size / data axis``."""
    nd = mesh.axis_size('data')
    if global_batch_size % nd:
        raise ValueError('global batch {} does not divide the data axis {}'
                         .format(global_batch_size, nd))
    local = process_shard(dataset, mesh.index('data'), nd)
    loader = DataLoader(local, global_batch_size // nd, shuffle=shuffle,
                        seed=seed, data_augmentation=data_augmentation,
                        drop_last=True)
    for x, y in loader:
        yield global_batch(mesh, x, y)
