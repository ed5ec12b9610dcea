"""The .jvr recorder file format: header spec, zero-copy reader, writers.

The port's own copy of ``joint_vae_tpu/save_load/native_store.py``: the
same bytes, so record files written by either package load in the other.
The C++ library ``native/recstore.cpp`` (built by ``make -C native`` at
first use) owns the hot write path (large pwrites + rolling crc32 + atomic
rename) and a streaming checksum verifier; a pure-Python writer with
identical output bytes backs everything when no compiler is available.
A .jvr opens as a zero-copy memory map (pages fault in only for the
components touched), carries a crc32 of its data region and is written
through tmp + rename (``sync=True`` adds an fdatasync).

Layout (little-endian)::

    0   magic   8s   b'JVTREC1\\n'
    8   header_len   u32   data region starts here (64-byte aligned)
    12  data_crc32   u32   IEEE crc32 of [header_len, file end)
    16  batch_size   u32
    20  recorded_batches u32
    24  last_batch_size  u32
    28  seed         i64   (-1 = none)
    36  n_keys       u32
    40  per key: u16 name_len, name; u8 dtype_len, dtype (numpy .str);
                 u8 ndim; u64 shape[ndim]; u64 offset (absolute)

Arrays are C-contiguous, 64-byte aligned, stored in offset order; the crc
covers alignment gaps (zeros) so it is a checksum of the raw region.
"""

import ctypes
import logging
import mmap
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

MAGIC = b'JVTREC1\n'
_CRC_OFFSET = 12
_ALIGN = 64

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), '..', '..', 'native')
_LIB_PATH = os.path.join(_NATIVE_DIR, 'librecstore.so')
_lib = None
_lib_failed = False


def _build() -> bool:
    import subprocess
    try:
        src = os.path.join(_NATIVE_DIR, 'recstore.cpp')
        r = subprocess.run(['make', '-C', _NATIVE_DIR, 'librecstore.so'],
                           capture_output=True, text=True, timeout=120)
        if r.returncode == 0:
            return True
        r = subprocess.run(
            ['g++', '-O3', '-std=c++17', '-fPIC', '-shared', src,
             '-o', _LIB_PATH],
            capture_output=True, text=True, timeout=120)
        return r.returncode == 0
    except (OSError, subprocess.TimeoutExpired) as e:
        logging.debug('recstore build unavailable: %s', e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    if not os.path.exists(_LIB_PATH) and not _build():
        _lib_failed = True
        logging.info('native recstore unavailable - using the python writer')
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.jvtrec_write.restype = ctypes.c_int
    lib.jvtrec_write.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint32)]
    lib.jvtrec_crc.restype = ctypes.c_int
    lib.jvtrec_crc.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32)]
    _lib = lib
    return lib


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _pack_header(tensors: Dict[str, np.ndarray], batch_size: int,
                 recorded_batches: int, last_batch_size: int,
                 seed: Optional[int]) -> Tuple[bytes, Dict[str, int], int]:
    """Serialize the header; returns (header bytes padded to alignment,
    key -> absolute data offset, total file length)."""
    entries = []
    fixed = struct.pack('<8sIIIIIqI', MAGIC, 0, 0, batch_size,
                        recorded_batches, last_batch_size,
                        -1 if seed is None else seed, len(tensors))
    # first pass with placeholder offsets to size the header
    for passno in range(2):
        offsets = {}
        pos = _align(len(fixed) + sum(len(e) for e in entries)) \
            if passno else 0
        entries = []
        for k, t in tensors.items():
            name = k.encode()
            dt = t.dtype.str.encode()
            if passno:
                offsets[k] = pos
            e = struct.pack('<H', len(name)) + name
            e += struct.pack('<B', len(dt)) + dt
            e += struct.pack('<B', t.ndim)
            e += struct.pack('<{}Q'.format(t.ndim), *t.shape)
            e += struct.pack('<Q', pos)
            entries.append(e)
            pos = _align(pos + t.nbytes)
        body = b''.join(entries)
    header_len = _align(len(fixed) + len(body))
    total_len = pos if tensors else header_len
    header = struct.pack('<8sIIIIIqI', MAGIC, header_len, 0, batch_size,
                         recorded_batches, last_batch_size,
                         -1 if seed is None else seed,
                         len(tensors)) + body
    header += b'\0' * (header_len - len(header))
    return header, offsets, max(total_len, header_len)


def write_jvr(path: str, tensors: Dict[str, np.ndarray], batch_size: int,
              recorded_batches: int, last_batch_size: int,
              seed: Optional[int] = None, sync: bool = False) -> None:
    """Write a .jvr file atomically (native writer, python fallback).

    ``sync`` forces an fdatasync before the rename (power-loss
    durability).  Off by default: recorders are a recomputable cache and
    the crc catches torn files.
    """
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tensors = {k: np.ascontiguousarray(v) for k, v in tensors.items()}
    header, offsets, total_len = _pack_header(
        tensors, batch_size, recorded_batches, last_batch_size, seed)
    lib = get_lib()
    if lib is not None:
        n = len(tensors)
        keys = list(tensors)
        ptrs = (ctypes.c_void_p * n)(
            *(tensors[k].ctypes.data for k in keys))
        nbytes = (ctypes.c_uint64 * n)(*(tensors[k].nbytes for k in keys))
        offs = (ctypes.c_uint64 * n)(*(offsets[k] for k in keys))
        crc = ctypes.c_uint32(0)
        rc = lib.jvtrec_write(path.encode(), header, len(header), n,
                              ptrs, nbytes, offs, total_len,
                              _CRC_OFFSET, int(sync), ctypes.byref(crc))
        if rc == 0:
            return
        logging.warning('jvtrec_write failed (errno %d) - python fallback',
                        -rc)
    _write_jvr_python(path, header, tensors, offsets, total_len, sync)


def _write_jvr_python(path: str, header: bytes,
                      tensors: Dict[str, np.ndarray],
                      offsets: Dict[str, int], total_len: int,
                      sync: bool = False) -> None:
    tmp = path + '.tmp'
    header_len = len(header)
    crc = 0
    with open(tmp, 'wb') as f:
        f.write(header)
        pos = header_len
        for k in tensors:  # offsets are in insertion order
            gap = offsets[k] - pos
            if gap:
                pad = b'\0' * gap
                f.write(pad)
                crc = zlib.crc32(pad, crc)
            t = tensors[k]
            f.write(memoryview(t).cast('B'))
            crc = zlib.crc32(t, crc)
            pos = offsets[k] + t.nbytes
        if pos < total_len:
            pad = b'\0' * (total_len - pos)
            f.write(pad)
            crc = zlib.crc32(pad, crc)
        f.seek(_CRC_OFFSET)
        f.write(struct.pack('<I', crc))
        f.flush()
        if sync:
            os.fsync(f.fileno())
    os.replace(tmp, path)


def _parse_header(buf: bytes):
    if buf[:8] != MAGIC:
        raise ValueError('not a .jvr file (bad magic)')
    (header_len, crc, batch_size, recorded, last, seed,
     n_keys) = struct.unpack_from('<IIIIIqI', buf, 8)
    pos = 40
    keys = []
    for _ in range(n_keys):
        (nl,) = struct.unpack_from('<H', buf, pos)
        pos += 2
        name = buf[pos:pos + nl].decode()
        pos += nl
        dl = buf[pos]
        pos += 1
        dt = buf[pos:pos + dl].decode()
        pos += dl
        ndim = buf[pos]
        pos += 1
        shape = struct.unpack_from('<{}Q'.format(ndim), buf, pos)
        pos += 8 * ndim
        (off,) = struct.unpack_from('<Q', buf, pos)
        pos += 8
        keys.append((name, dt, shape, off))
    meta = dict(header_len=header_len, crc=crc, batch_size=batch_size,
                recorded_batches=recorded, last_batch_size=last,
                seed=None if seed < 0 else seed)
    return meta, keys


def peek_jvr(path: str):
    """Header-only probe: meta dict + component names, no data read."""
    meta, keys = _parse_header(_read_header_bytes(path))
    meta['components'] = [k[0] for k in keys]
    return meta


def read_jvr(path: str, writeable: bool = False):
    """Open a .jvr file; returns (meta, {key: array}).

    Arrays are zero-copy views over a shared read-only memory map (pages
    fault in lazily); pass ``writeable=True`` to get private copies.
    """
    with open(path, 'rb') as f:
        meta, keys = _parse_header(_read_header(f))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    arrays = {}
    for name, dt, shape, off in keys:
        a = np.frombuffer(mm, dtype=np.dtype(dt),
                          count=int(np.prod(shape, dtype=np.int64)),
                          offset=off).reshape(shape)
        arrays[name] = a.copy() if writeable else a
    a = None                 # a view exports the map's buffer: drop it
    if writeable:
        mm.close()
    return meta, arrays


def verify_jvr(path: str) -> bool:
    """Recompute the data-region checksum and compare with the header."""
    meta, _ = _parse_header(_read_header_bytes(path))
    size = os.path.getsize(path)
    start = meta['header_len']
    lib = get_lib()
    if lib is not None:
        crc = ctypes.c_uint32(0)
        rc = lib.jvtrec_crc(path.encode(), start, size - start,
                            ctypes.byref(crc))
        return rc == 0 and crc.value == meta['crc']
    crc = 0
    with open(path, 'rb') as f:
        f.seek(start)
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc == meta['crc']


def _read_header(f) -> bytes:
    """The header's bytes, read from the start of an open .jvr file."""
    head = f.read(40)
    if head[:8] != MAGIC:
        raise ValueError('not a .jvr file (bad magic)')
    (header_len,) = struct.unpack_from('<I', head, 8)
    return head + f.read(header_len - 40)


def _read_header_bytes(path: str) -> bytes:
    with open(path, 'rb') as f:
        return _read_header(f)
