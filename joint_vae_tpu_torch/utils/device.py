"""Device utilities: the largest batch that fits, and crash dumps.

Port of ``joint_vae_tpu/utils/device.py``:

- :func:`compute_max_batch_size` (ref cvae.py:1087-1143) runs a step at
  doubling batch sizes until the card runs out of memory
  (``torch.OutOfMemoryError``, or an error whose message says so), frees
  the allocator's cache after each failure so the card is whole for what
  runs next, halves below ``start`` when ``start`` itself does not fit,
  and caches the result per ``key``;
- :func:`dump_crash` (ref cvae.py:479-488) saves the job and the batch
  that failed under ``log/dump-<job>``.

The JAX package's third utility, ``enable_compilation_cache``, keeps
XLA's compiled programs across runs.  The port compiles no program at run
time; its counterpart is the CUDA kernels' build directory
(``ops/cuda_lib.py``), whose libraries are keyed by a hash of their
source and reused by every later run.
"""

import logging
import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

_max_batch_cache: Dict[Tuple, int] = {}


def _is_oom(e: Exception) -> bool:
    """The caching allocator's ``torch.OutOfMemoryError``; the JAX
    package's message tests; CUDA's own 'out of memory' and a library's
    failed workspace allocation (``CUBLAS_STATUS_ALLOC_FAILED``,
    ``CUDNN_STATUS_ALLOC_FAILED``)."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    s = str(e)
    return ('RESOURCE_EXHAUSTED' in s or 'ALLOC_FAILED' in s
            or 'out of memory' in s.lower() or 'oom' in s.lower())


def _free_cache():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _fits(step_fn: Callable[[int], None], n: int) -> bool:
    """``step_fn(n)`` ran; False if it ran out of memory (any other error
    propagates).  The failed step's tensors are released (the exception
    and its frames dropped) before the cache is freed."""
    try:
        step_fn(n)
        return True
    except Exception as e:
        if not _is_oom(e):
            raise
        logging.info('batch %d exhausts device memory', n)
    _free_cache()
    return False


def compute_max_batch_size(step_fn: Callable[[int], None], start: int = 128,
                           ceiling: int = 65536, key: Tuple = ()) -> int:
    """Largest power-of-two multiple of ``start`` (or ``start`` halved) <=
    ceiling for which ``step_fn(n)`` runs without exhausting device
    memory; 0 when not even a batch of 1 fits."""
    if key in _max_batch_cache:
        return _max_batch_cache[key]
    n = start
    best = 0
    while n <= ceiling:
        if not _fits(step_fn, n):
            break
        best = n
        n *= 2
    # the starting size may itself exhaust memory: halve downward like the
    # reference (cvae.py:1087-1143) instead of reporting 0
    n = start // 2
    while best == 0 and n >= 1:
        if _fits(step_fn, n):
            best = n
        n //= 2
    if key:
        _max_batch_cache[key] = best
    return best


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def dump_crash(job, x, y, error: Exception, log_dir: str = 'log') -> str:
    """Save the job (``save_job``) and the batch that triggered a failure
    (``batch.npz``, its tensors brought to the host) with the error's
    repr under ``<log_dir>/dump-<job number>``; returns that directory."""
    d = os.path.join(log_dir, 'dump-{}'.format(getattr(job, 'job_number', 0)))
    os.makedirs(d, exist_ok=True)
    try:
        from ..save_load.jobs import save_job
        save_job(job, d)
    except Exception as e:
        logging.error('could not save job in crash dump: %s', e)
    np.savez(os.path.join(d, 'batch.npz'), x=_host(x),
             y=_host(y) if y is not None else np.zeros(0))
    with open(os.path.join(d, 'error.txt'), 'w') as f:
        f.write(repr(error))
    logging.error('Error %s, net dumped in %s', error, d)
    return d
