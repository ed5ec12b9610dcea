"""ctypes binding of the native C++ batcher (``native/batcher.cpp``).

Port of ``joint_vae_tpu/data/native.py`` over the same library,
``native/libjvtbatcher.so``, which ``make -C native`` builds at first use
(a direct g++ call when make fails), as ``save_load/native_store.py``
builds ``librecstore.so``.  :class:`NativeBatcher` is the batch source of
``DataLoader(use_native=...)``; with no compiler, ``available()`` is
false and the loader takes its numpy path (logged once).  This is host
code: it assembles float32 batches in host memory.
"""

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), '..', '..', 'native')
_LIB_PATH = os.path.join(_NATIVE_DIR, 'libjvtbatcher.so')
_lib = None
_build_failed = False


def _build() -> bool:
    try:
        r = subprocess.run(['make', '-C', _NATIVE_DIR, 'libjvtbatcher.so'],
                           capture_output=True, text=True, timeout=120)
        if r.returncode == 0:
            return True
        logging.debug('make failed: %s', r.stderr)
        r = subprocess.run(
            ['g++', '-O3', '-std=c++17', '-fPIC', '-shared', '-pthread',
             os.path.join(_NATIVE_DIR, 'batcher.cpp'), '-o', _LIB_PATH],
            capture_output=True, text=True, timeout=120)
        return r.returncode == 0
    except (OSError, subprocess.TimeoutExpired) as e:
        logging.debug('native build unavailable: %s', e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built first if need be), or None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_LIB_PATH) and not _build():
        _build_failed = True
        logging.info('native batcher unavailable - using the numpy loader')
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.jvt_batcher_create_v2.restype = ctypes.c_void_p
    lib.jvt_batcher_create_v2.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.jvt_batcher_destroy.argtypes = [ctypes.c_void_p]
    lib.jvt_batcher_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                            ctypes.c_int]
    lib.jvt_batcher_get_batch.restype = ctypes.c_int64
    lib.jvt_batcher_get_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


class NativeBatcher:
    """A native handle over the dataset's arrays (held here: the library
    does not copy them).

    ``data`` is float32 in [0, 1] or uint8 (scaled by 1/255 as batches are
    assembled).  Each epoch's order comes from (seed, epoch); ``hflip``
    and ``crop_pad`` apply the random flip and crop in the same
    multithreaded gather.  (The library's resize and normalisation,
    which no loader of either package asks for, are left off.)"""

    def __init__(self, data: np.ndarray, labels: np.ndarray, seed: int = 0,
                 hflip: bool = False, crop_pad: int = 0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError('native batcher not available')
        self._lib = lib
        is_u8 = np.asarray(data).dtype == np.uint8
        self._data = np.ascontiguousarray(data,
                                          np.uint8 if is_u8 else np.float32)
        self._labels = np.ascontiguousarray(labels, np.int32)
        n, c, h, w = self._data.shape
        self.shape = (c, h, w)
        self.n = n
        self._h = lib.jvt_batcher_create_v2(
            self._data.ctypes.data_as(ctypes.c_void_p), int(is_u8),
            self._labels.ctypes.data_as(ctypes.c_void_p),
            n, c, h, w, h, w, seed & 0xffffffffffffffff,
            int(bool(hflip)), int(crop_pad), None, None)

    def start_epoch(self, epoch: int, shuffle: bool = True):
        self._lib.jvt_batcher_start_epoch(self._h, epoch, int(bool(shuffle)))

    def get_batch(self, index: int, batch_size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch ``index`` of the epoch's order (shorter at the tail), in
        new arrays."""
        out_x = np.empty((batch_size,) + self.shape, np.float32)
        out_y = np.empty((batch_size,), np.int32)
        bs = self._lib.jvt_batcher_get_batch(
            self._h, index, batch_size,
            out_x.ctypes.data_as(ctypes.c_void_p),
            out_y.ctypes.data_as(ctypes.c_void_p))
        if bs < 0:
            raise IndexError(index)
        return out_x[:bs], out_y[:bs]

    def __del__(self):
        try:
            if getattr(self, '_h', None):
                self._lib.jvt_batcher_destroy(self._h)
        except Exception:
            pass
