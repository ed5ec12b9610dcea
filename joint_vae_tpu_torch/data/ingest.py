"""ImageFolder ingestion: one parallel decode of the tree into a uint8
memmap cache, then memory-mapped opens.

Port of ``joint_vae_tpu/data/ingest.py``, with the same cache key, file
names, label file and meta file, so each package opens the other's cache:

- the first touch decodes the tree once with a pool of decode
  subprocesses into ``<root>/.jvt_cache/<tag>-<C>x<H>x<W>-<hash>.u8``
  (uint8; the workers write disjoint rows of one memmap, so the resident
  memory stays at a few decode buffers whatever the tree's size);
- the workers are ``python -S data/ingest_worker.py`` subprocesses that
  import numpy and PIL only, not a ``multiprocessing`` fork: this process
  holds torch's threads (and CUDA's), and a forked child of a threaded
  process can deadlock on a lock it inherited;
- later runs open the cache as a read-only ``np.memmap``; batches become
  float32 in [0, 1] per batch (``loaders.to_float``), and the
  device-resident dataset keeps it uint8 on the card;
- the key hashes every file's (relative path, label, size, mtime_ns) and
  the target shape, so touching the tree invalidates the cache.

The labels (``.y.npy``) and a meta JSON sit beside the ``.u8``; the meta
file is written last (an atomic rename), so a crashed ingest never
presents a complete cache, and a worker that dies fails the ingest.
"""

import json
import logging
import os
import subprocess
import sys
import tempfile
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

EXTS = ('.jpg', '.jpeg', '.png', '.bmp')
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'ingest_worker.py')


def list_folder(base: str, allowed: Optional[Sequence[str]] = None):
    """-> (sorted class names, [(path, label)]) for base/<class>/*.img
    (hidden directories, the cache among them, skipped)."""
    classes = sorted(d for d in os.listdir(base)
                     if os.path.isdir(os.path.join(base, d))
                     and not d.startswith('.'))
    if allowed:
        allowed = set(allowed)
        classes = [c for c in classes if c in allowed]
    files: List[Tuple[str, int]] = []
    for yi, cname in enumerate(classes):
        cdir = os.path.join(base, cname)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(EXTS):
                files.append((os.path.join(cdir, fn), yi))
    return classes, files


def decode_one(path: str, shape) -> np.ndarray:
    """Decode and resize one image file to (C, H, W) uint8 (PIL, imported
    here only)."""
    from PIL import Image
    c, h, w = shape
    img = Image.open(path).convert('RGB' if c == 3 else 'L').resize((w, h))
    arr = np.asarray(img, np.uint8)
    return arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)


def _cache_key(base: str, files, shape) -> str:
    crc = zlib.crc32(repr(tuple(shape)).encode())
    for path, label in files:
        st = os.stat(path)
        rec = '{}|{}|{}|{}'.format(os.path.relpath(path, base), label,
                                   st.st_size, st.st_mtime_ns)
        crc = zlib.crc32(rec.encode(), crc)
    return '{:08x}'.format(crc)


def _cache_dir(base: str) -> str:
    """<base>/.jvt_cache, or ~/.cache/jvt_ingest where base is read-only."""
    d = os.path.join(base, '.jvt_cache')
    try:
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(d, '.probe')
        with open(probe, 'w'):
            pass
        os.unlink(probe)
        return d
    except OSError:
        alt = os.path.join(os.path.expanduser('~'), '.cache', 'jvt_ingest')
        os.makedirs(alt, exist_ok=True)
        return alt


def _cache_paths(base: str, files, shape):
    c, h, w = shape
    key = _cache_key(base, files, shape)
    cdir = _cache_dir(base)
    tag = '{}-{}x{}x{}-{}'.format(
        os.path.basename(os.path.normpath(base)) or 'data', c, h, w, key)
    return (os.path.join(cdir, tag + '.u8'),
            os.path.join(cdir, tag + '.y.npy'),
            os.path.join(cdir, tag + '.json'), cdir)


def _open_cache(mm_path, y_path, meta_path, n, shape):
    """-> (uint8 memmap, labels) if a complete cache is there, else None.
    Every file and the memmap's size are checked: a cleaner may delete the
    large .u8 and keep the small .json, which is then a miss."""
    c, h, w = shape
    if not os.path.exists(meta_path):
        return None
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        if (meta.get('n') != n
                or os.path.getsize(mm_path) != n * c * h * w):
            return None
        labels = np.load(y_path)
        if labels.shape != (n,):
            return None
    except (OSError, ValueError):
        return None
    x = np.memmap(mm_path, dtype=np.uint8, mode='r', shape=(n, c, h, w))
    return x, labels


def _spawn_decoders(mm_path, files, n, shape, workers, cdir) -> List[str]:
    """Decode ``files`` into ``mm_path`` with ``workers`` subprocesses over
    contiguous index ranges; -> one error string per failed file, or one
    per worker that exited nonzero without saying why (killed, crashed)."""
    site_dir = os.path.dirname(os.path.dirname(np.__file__))
    per = (n + workers - 1) // workers
    procs = []
    for w0 in range(0, n, per):
        entries = [[i, files[i][0]] for i in range(w0, min(w0 + per, n))]
        fd, jf = tempfile.mkstemp(dir=cdir, suffix='.jobs')
        with os.fdopen(fd, 'w') as f:
            json.dump({'mm': mm_path, 'n': n, 'shape': list(shape),
                       'entries': entries}, f)
        p = subprocess.Popen([sys.executable, '-S', WORKER, site_dir, jf],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((p, jf))
    errors: List[str] = []
    for p, jf in procs:
        out, _ = p.communicate()
        os.unlink(jf)
        if p.returncode != 0:
            lines = [l for l in out.splitlines() if l.strip()]
            errors.extend(lines or
                          ['decode worker exited {}'.format(p.returncode)])
    return errors


def open_cached_image_folder(base: str, shape,
                             allowed: Optional[Sequence[str]] = None):
    """A warm cache only: -> (uint8 memmap, labels, classes) or None.
    Reads the tree's stats and no image (no PIL needed)."""
    classes, files = list_folder(base, allowed)
    if not files:
        return None
    mm_path, y_path, meta_path, _ = _cache_paths(base, files, shape)
    got = _open_cache(mm_path, y_path, meta_path, len(files), shape)
    if got is None:
        return None
    return got[0], got[1], classes


def ingest_image_folder(base: str, shape,
                        allowed: Optional[Sequence[str]] = None,
                        workers: Optional[int] = None,
                        chunk: int = 256):
    """-> (uint8 memmap (N, C, H, W), labels int32, classes) or None.

    Decodes the tree into the cache once, then memory-maps it.
    ``workers`` (default ``JVT_INGEST_WORKERS``, else the CPU count)
    decode subprocesses run when there is more than one and more than
    ``chunk`` files; otherwise this process decodes them in a loop."""
    classes, files = list_folder(base, allowed)
    if not files:
        return None
    c, h, w = shape
    mm_path, y_path, meta_path, cdir = _cache_paths(base, files, shape)
    n = len(files)
    labels = np.asarray([lb for _, lb in files], np.int32)
    got = _open_cache(mm_path, y_path, meta_path, n, shape)
    if got is not None:
        return got[0], got[1], classes

    workers = workers or int(os.environ.get('JVT_INGEST_WORKERS', 0)) \
        or (os.cpu_count() or 1)
    with open(mm_path, 'wb') as f:
        f.truncate(n * c * h * w)
    errors: List[str] = []
    if workers > 1 and n > chunk:
        errors = _spawn_decoders(mm_path, files, n, shape, workers, cdir)
    else:
        mm = np.memmap(mm_path, dtype=np.uint8, mode='r+',
                       shape=(n, c, h, w))
        for i, (p, _) in enumerate(files):
            try:
                mm[i] = decode_one(p, shape)
            except Exception as e:   # the slot stays zero; reported
                errors.append('{}: {}'.format(p, e))
        mm.flush()
        del mm
    if errors:
        os.unlink(mm_path)
        raise RuntimeError('ingest failed on {} file(s), e.g. {}'.format(
            len(errors), errors[0]))
    np.save(y_path, labels)
    fd, tmp = tempfile.mkstemp(dir=cdir, suffix='.tmp')
    with os.fdopen(fd, 'w') as f:
        json.dump({'n': n, 'shape': [c, h, w], 'classes': classes,
                   'base': os.path.abspath(base)}, f)
    os.replace(tmp, meta_path)
    logging.info('ingested %d images from %s into %s', n, base, mm_path)
    x = np.memmap(mm_path, dtype=np.uint8, mode='r', shape=(n, c, h, w))
    return x, labels, classes
