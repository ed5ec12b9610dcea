"""Whole-array datasets, the file readers, the dataset registry's
``get_dataset`` and the seeded batch loader.

Port of ``joint_vae_tpu/data/loaders.py`` (ref ``utils/torch_load.py:150-580``):
datasets are whole-array numpy containers (float32 CHW in [0, 1], or
uint8, with int labels); transform micro-DSL, heldout-class filtering and
relabeling, rotation-suffix views, synthetic const/uniform sets and the
seeded batch utilities follow the reference.  For the same name, split and
size the arrays equal the JAX package's: both are numpy from the same
seeds.

Real data is read from $JVT_DATA_DIR (default ./data) in the standard
formats (MNIST idx, CIFAR python pickles, npz, SVHN .mat, image folders,
DTD, LSUN).  When the files are absent the loader falls back to a flagged
(``synthetic=True``) deterministic class-structured substitute, so every
pipeline stays runnable; ``require_real`` makes that an error instead.

Image folders go through the uint8 memmap ingest cache (``data/ingest.py``;
``JVT_INGEST_CACHE=0`` decodes in this process instead, to the same
bytes).  :class:`DataLoader` takes the native batcher (``data/native.py``)
where the JAX package takes it: by default whenever it builds, for flip
and crop augmentation only and never over a memmap; its batches equal
the JAX package's native ones.  Otherwise it is the numpy path: the epoch
permutation and the augmentation draws come from
``np.random.default_rng((seed, epoch))``, as in the JAX package's.
"""

import gzip
import logging
import os
import pickle
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ingest import (decode_one, ingest_image_folder, list_folder,
                     open_cached_image_folder)
from .registry import (dataset_properties, get_classes_by_name,
                       get_heldout_classes_by_name, get_same_size_by_name)

DATA_DIR = os.environ.get('JVT_DATA_DIR', './data')


def to_float(x: np.ndarray) -> np.ndarray:
    """uint8 image arrays -> float32 in [0,1]; float passes through."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x.astype(np.float32) * np.float32(1.0 / 255.0)
    return x


class ArrayDataset:
    """In-memory dataset: data (N, C, H, W) float32 in [0,1] (or uint8,
    converted lazily per batch), targets (N,), and the registry's metadata:
    class names, transformer, held-out classes, the synthetic flag and the
    same-size OOD companions."""

    def __init__(self, data: np.ndarray, targets: np.ndarray, name: str,
                 classes: Optional[List[str]] = None,
                 transformer: str = 'default', heldout: Sequence[int] = (),
                 synthetic: bool = False, same_size: Sequence[str] = ()):
        if data.ndim != 4:
            raise ValueError('ArrayDataset wants (N, C, H, W) data, got '
                             'shape {}'.format(data.shape))
        if data.dtype == np.uint8:
            self.data = data
        else:
            self.data = np.ascontiguousarray(data, np.float32)
        self.targets = np.ascontiguousarray(targets, np.int32)
        self.name = name
        self.classes = classes
        self.transformer = transformer
        self.heldout = tuple(heldout)
        self.synthetic = synthetic
        self.same_size = list(same_size)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, i):
        return to_float(self.data[i]), self.targets[i]

    @property
    def shape(self):
        return tuple(self.data.shape[1:])

    def subset(self, indices) -> 'ArrayDataset':
        return ArrayDataset(self.data[indices], self.targets[indices],
                            self.name, self.classes, self.transformer,
                            self.heldout, self.synthetic, self.same_size)


# ---------------------------------------------------------------------------
# raw file readers
# ---------------------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    op = gzip.open if path.endswith('.gz') else open
    with op(path, 'rb') as f:
        magic = struct.unpack('>I', f.read(4))[0]
        ndim = magic & 0xff
        dims = struct.unpack('>' + 'I' * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _load_mnist_like(root: str, split: str):
    prefix = 'train' if split == 'train' else 't10k'
    for ext in ('', '.gz'):
        ip = os.path.join(root, '{}-images-idx3-ubyte{}'.format(prefix, ext))
        lp = os.path.join(root, '{}-labels-idx1-ubyte{}'.format(prefix, ext))
        if os.path.exists(ip) and os.path.exists(lp):
            x = _read_idx(ip).astype(np.float32) / 255.0
            y = _read_idx(lp).astype(np.int32)
            return x[:, None], y
    return None


def _stable_seed(*parts) -> int:
    """Process-independent seed for deterministic synthetic data —
    Python's hash() is salted per interpreter, which would regenerate a
    different 'deterministic' set in every process."""
    return zlib.crc32('\x1f'.join(str(p) for p in parts).encode())


def _load_cifar(root: str, split: str, want: str = 'cifar10'):
    """Read the CIFAR python-pickle layout matching the REQUESTED set
    (with both layouts on disk, checking cifar-10 first used to hand
    cifar-100 callers 10-class data silently)."""
    b10 = os.path.join(root, 'cifar-10-batches-py')
    if want != 'cifar100' and os.path.isdir(b10):
        files = (['data_batch_{}'.format(i) for i in range(1, 6)]
                 if split == 'train' else ['test_batch'])
        xs, ys = [], []
        for fn in files:
            with open(os.path.join(b10, fn), 'rb') as f:
                d = pickle.load(f, encoding='bytes')
            xs.append(d[b'data'])
            ys.extend(d[b'labels'])
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
        return x, np.asarray(ys, np.int32)
    b100 = os.path.join(root, 'cifar-100-python')
    if want != 'cifar10' and os.path.isdir(b100):
        fn = 'train' if split == 'train' else 'test'
        with open(os.path.join(b100, fn), 'rb') as f:
            d = pickle.load(f, encoding='bytes')
        x = d[b'data'].reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
        y = np.asarray(d[b'fine_labels'], np.int32)
        return x, y
    return None


def _load_image_folder(root: str, shape, split: str,
                       class_file: Optional[str] = None):
    """ImageFolder reader (ref ImageFolderWithClassesInFile,
    utils/torch_load.py:250-294): root/<split>/<class>/*.img, optionally
    restricted to class ids listed in a txt file (imagenet1k/20/2), as
    uint8 through the ingest cache (``data/ingest.py``): a warm cache opens
    without PIL, a cold one is decoded once.  ``JVT_INGEST_CACHE=0`` (or
    off/false/no/none) decodes the tree in this process instead."""
    base = os.path.join(root, split)
    if not os.path.isdir(base) and split == 'test':
        # ImageNet-layout trees name the eval split 'val' (ref sets.ini
        # imagenet split kwargs / torchvision ImageNet)
        base = os.path.join(root, 'val')
    if not os.path.isdir(base):
        base = root
    if not os.path.isdir(base):
        return None
    if base == root and any(
            os.path.isdir(os.path.join(root, s))
            for s in ('train', 'val', 'test')):
        # a split-structured tree must never fall back to the whole root
        # (the split dirs would be read as class folders)
        return None
    allowed = None
    if class_file and os.path.exists(class_file):
        with open(class_file) as f:
            allowed = [l.split()[0] for l in f
                       if l.strip() and not l.startswith('#')]
    cache_on = (os.environ.get('JVT_INGEST_CACHE', '1').strip().lower()
                not in ('0', 'off', 'false', 'no', 'none'))
    if cache_on:
        got = open_cached_image_folder(base, shape, allowed)
        if got is not None:
            return got[0], got[1]
    try:
        import PIL  # noqa: F401 — the decoder
    except ImportError:
        return None
    if not cache_on:
        _, files = list_folder(base, allowed)
        if not files:
            return None
        x = np.stack([decode_one(p, shape) for p, _ in files])
        return x, np.asarray([lb for _, lb in files], np.int32)
    got = ingest_image_folder(base, shape, allowed)
    return None if got is None else (got[0], got[1])


def _load_npz(root: str, name: str, split: str):
    for cand in (os.path.join(root, '{}-{}.npz'.format(name, split)),
                 os.path.join(root, name, '{}.npz'.format(split))):
        if os.path.exists(cand):
            z = np.load(cand)
            x = z['x'].astype(np.float32)
            if x.max() > 1.5:
                x = x / 255.0
            y = z.get('y', np.zeros(len(x), np.int32)).astype(np.int32)
            return x, y
    return None


def _load_svhn_mat(root: str, split: str):
    """SVHN cropped-digits .mat reader (ref sets.ini [svhn] via torchvision
    SVHN): {split}_32x32.mat with X (32, 32, 3, N) uint8 and y in 1..10
    where 10 means digit 0."""
    path = os.path.join(root, '{}_32x32.mat'.format(split))
    if not os.path.exists(path):
        return None
    import scipy.io
    m = scipy.io.loadmat(path)
    x = m['X'].transpose(3, 2, 0, 1).astype(np.float32) / 255.0
    y = m['y'].reshape(-1).astype(np.int32) % 10
    return x, y


def _load_npy_dir(root: str, split: str, size: Optional[int] = None):
    """Single-.npy-per-split reader (ref FromNumpy, torch_load.py:189-220;
    random300k layout data/300k-random/<split>/*.npy of (N, H, W, 3) uint8).
    Memmapped + truncated to ``size`` before the float conversion so 300k
    images do not need 4 GB of host RAM."""
    d = os.path.join(root, split)
    if not os.path.isdir(d):
        return None
    files = [f for f in os.listdir(d) if f.endswith('.npy')]
    if len(files) != 1:
        return None
    arr = np.load(os.path.join(d, files[0]), mmap_mode='r')
    if size:
        arr = arr[:size]
    x = np.asarray(arr)
    if x.ndim == 4 and x.shape[-1] in (1, 3):      # NHWC -> NCHW
        x = x.transpose(0, 3, 1, 2)
    elif x.ndim == 3:                               # grayscale NHW
        x = x[:, None]
    x = x.astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    return x, np.zeros(len(x), np.int32)


def _read_images(paths, shape, center_crop: Optional[int] = None,
                 resize: bool = True):
    """Decode + (center-crop) + resize a list of image files to CHW float."""
    try:
        from PIL import Image
    except ImportError:
        return None
    c0, h, w = shape
    xs = []
    for p in paths:
        img = Image.open(p).convert('RGB' if c0 == 3 else 'L')
        if center_crop:
            side = min(img.size + (center_crop,))
            left = (img.size[0] - side) // 2
            top = (img.size[1] - side) // 2
            img = img.crop((left, top, left + side, top + side))
        if resize:
            img = img.resize((w, h))
        arr = np.asarray(img, np.float32) / 255.0
        xs.append(arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1))
    return np.stack(xs) if xs else None


def _load_dtd(root: str, shape, split: str, size: Optional[int] = None):
    """DTD texture reader (ref DTDConcatTestVal, torch_load.py:224-248):
    torchvision layout <root>/dtd/{images/<class>/*.jpg, labels/<split>1.txt};
    the 'test' split concatenates test1 + val1."""
    base = os.path.join(root, 'dtd') if os.path.isdir(
        os.path.join(root, 'dtd', 'images')) else root
    images = os.path.join(base, 'images')
    labels = os.path.join(base, 'labels')
    if not os.path.isdir(images):
        return None
    split_files = ['train1.txt'] if split == 'train' else ['test1.txt',
                                                           'val1.txt']
    rel = []
    for fn in split_files:
        p = os.path.join(labels, fn)
        if os.path.exists(p):
            with open(p) as f:
                rel += [l.strip() for l in f if l.strip()]
    if not rel:       # no label lists: take every image
        rel = [os.path.join(c, f) for c in sorted(os.listdir(images))
               if os.path.isdir(os.path.join(images, c))
               for f in sorted(os.listdir(os.path.join(images, c)))]
    if size:
        rel = rel[:size]
    classes = sorted({r.split('/')[0] for r in rel})
    cls_idx = {c: i for i, c in enumerate(classes)}
    x = _read_images([os.path.join(images, r) for r in rel], shape,
                     center_crop=256)
    if x is None:
        return None
    y = np.asarray([cls_idx[r.split('/')[0]] for r in rel], np.int32)
    return x, y


def _load_lsun(root: str, shape, split: str, mode: str = 'crop',
               size: Optional[int] = None):
    """LSUN reader (ref sets.ini [lsunc]/[lsunr] via torchvision LSUN).

    Two layouts: exported image folders <root>/<category>_<split>/*.jpg|webp
    (use scripts/prepare_data.py to export), or the original
    <category>_<split>_lmdb databases when the ``lmdb`` module is available
    (an optional dependency, imported only then).  'crop' center-crops
    to the target size, 'resize' center-crops to a square then scales."""
    if not os.path.isdir(root):
        return None
    suffix = '_{}'.format(split)
    cats = sorted(d[:-len(suffix)] for d in os.listdir(root)
                  if d.endswith(suffix)
                  and os.path.isdir(os.path.join(root, d)))
    if cats:
        per_cat = max(1, size // len(cats)) if size else None
        xs, ys = [], []
        for yi, c in enumerate(cats):
            d = os.path.join(root, c + suffix)
            files = sorted(f for f in os.listdir(d) if f.lower().endswith(
                ('.jpg', '.jpeg', '.png', '.webp', '.bmp')))[:per_cat]
            got = _read_images(
                [os.path.join(d, f) for f in files], shape,
                center_crop=(shape[1] if mode == 'crop' else 256),
                resize=(mode != 'crop'))
            if got is not None:
                xs.append(got)
                ys.append(np.full(len(got), yi, np.int32))
        if xs:
            return np.concatenate(xs), np.concatenate(ys)
    # original lmdb databases
    try:
        import lmdb  # optional dependency
    except ImportError:
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    import io
    dbs = sorted(d for d in os.listdir(root) if d.endswith(
        '{}_lmdb'.format(suffix)))
    xs, ys = [], []
    per_db = max(1, size // len(dbs)) if (size and dbs) else None
    for yi, db in enumerate(dbs):
        env = lmdb.open(os.path.join(root, db), readonly=True, lock=False)
        with env.begin() as txn:
            cur = txn.cursor()
            imgs = []
            for i, (_, buf) in enumerate(cur):
                if per_db and i >= per_db:
                    break
                imgs.append(Image.open(io.BytesIO(buf)).convert('RGB'))
        c0, h, w = shape
        for img in imgs:
            if mode == 'crop':
                side = shape[1]
            else:
                side = min(img.size)
            left = (img.size[0] - side) // 2
            top = (img.size[1] - side) // 2
            img = img.crop((left, top, left + side, top + side))
            if mode != 'crop':
                img = img.resize((w, h))
            xs.append(np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0)
            ys.append(yi)
    if not xs:
        return None
    return np.stack(xs), np.asarray(ys, np.int32)


_DEFAULT_SIZES = {'train': 50000, 'test': 10000}


def _procedural_shapes(name: str, shape, num_labels: int, split: str,
                       size: Optional[int] = None):
    """shapes32: 10 geometric classes with nuisance position / scale / hue
    variation.  Vectorized; deterministic per (name, split)."""
    n = size or {'train': 20000, 'test': 4000}[split]
    c, h, w = shape
    rng = np.random.default_rng(_stable_seed(name, split))
    y = rng.integers(0, num_labels, n).astype(np.int32)
    cy = rng.uniform(0.3, 0.7, n)[:, None, None] * h
    cx = rng.uniform(0.3, 0.7, n)[:, None, None] * w
    r = rng.uniform(0.18, 0.34, n)[:, None, None] * h
    hue = rng.uniform(0, 1, (n, 3))[:, :, None, None].astype(np.float32)
    yy = np.arange(h, dtype=np.float32)[None, :, None]
    xx = np.arange(w, dtype=np.float32)[None, None, :]
    dy, dx = yy - cy, xx - cx
    dist = np.sqrt(dy ** 2 + dx ** 2)
    cheb = np.maximum(np.abs(dy), np.abs(dx))
    period = np.maximum(r / 2, 2.0)
    masks = [
        dist <= r,                                            # disk
        (dist <= r) & (dist >= 0.55 * r),                     # ring
        cheb <= 0.8 * r,                                      # square
        (cheb <= 0.8 * r) & (cheb >= 0.45 * r),               # frame
        ((np.abs(dy) <= 0.25 * r) | (np.abs(dx) <= 0.25 * r)) & (cheb <= r),
        np.abs(dy) <= 0.3 * r,                                # hbar
        np.abs(dx) <= 0.3 * r,                                # vbar
        (np.floor(dy / period) % 2 == 0) & (cheb <= r),       # stripes
        ((np.floor(dy / period) + np.floor(dx / period)) % 2 == 0)
        & (cheb <= r),                                        # checker
        dist <= 0.4 * r,                                      # dot
    ]
    mask = np.zeros((n, h, w), np.float32)
    for ci in range(num_labels):
        sel = y == ci
        mask[sel] = masks[ci % len(masks)][sel]
    x = 0.12 + 0.8 * mask[:, None] * hue
    x = x + 0.03 * rng.standard_normal((n, c, h, w)).astype(np.float32)
    return np.clip(x, 0, 1).astype(np.float32), y


def _synthetic_fallback(name: str, shape, num_labels: int, split: str,
                        size: Optional[int] = None):
    """Deterministic class-structured blobs; clearly flagged synthetic."""
    n = size or _DEFAULT_SIZES[split]
    seed = _stable_seed(name, split)
    rng = np.random.default_rng(seed)
    C = max(num_labels, 1)
    y = rng.integers(0, C, size=n).astype(np.int32)
    c, h, w = shape
    centers = rng.uniform(0.2, 0.8, size=(C, c, 1, 1)).astype(np.float32)
    freq = rng.uniform(1, 4, size=(C, 1, 1, 1)).astype(np.float32)
    yy = np.linspace(0, np.pi, h, dtype=np.float32)[None, :, None]
    xx = np.linspace(0, np.pi, w, dtype=np.float32)[None, None, :]
    pattern = np.sin(freq[y] * yy)[..., :] * np.cos(freq[y] * xx)
    x = centers[y] + 0.15 * pattern + 0.05 * rng.standard_normal(
        (n, c, h, w)).astype(np.float32)
    return np.clip(x, 0, 1), y


# ---------------------------------------------------------------------------
# transform micro-DSL (ref data/sets.ini pre_transform strings)
# ---------------------------------------------------------------------------

def _apply_transforms(x: np.ndarray, y: np.ndarray, pre: str, target: str,
                      out_shape) -> Tuple[np.ndarray, np.ndarray]:
    for t in (pre or '').split():
        if t == 'tensor' or t == 'already_tensor':
            continue
        if t == 'g2c':
            if x.shape[1] == 1:
                x = np.repeat(x, 3, axis=1)
        elif t.startswith('pad-'):
            p = int(t.split('-')[1])
            x = np.pad(x, ((0, 0), (0, 0), (p, p), (p, p)))
        elif t == 'resize':
            x = _resize_nearest(x, out_shape[-2:])
        elif t.startswith('rotate-'):
            k = int(t.split('-')[1]) // 90
            x = np.rot90(x, k=k, axes=(2, 3)).copy()
        elif t == 'hflip':
            x = x[:, :, :, ::-1].copy()
        elif t.startswith('crop'):
            ch, cw = out_shape[-2:]
            h0 = (x.shape[2] - ch) // 2
            w0 = (x.shape[3] - cw) // 2
            x = x[:, :, h0:h0 + ch, w0:w0 + cw]
        else:
            logging.warning('unknown pre transform %s', t)
    if target == 'y-1':
        y = y - 1
    return x, y


def _resize_nearest(x: np.ndarray, hw) -> np.ndarray:
    h, w = hw
    ih, iw = x.shape[2], x.shape[3]
    ri = (np.arange(h) * ih // h).clip(0, ih - 1)
    ci = (np.arange(w) * iw // w).clip(0, iw - 1)
    return x[:, :, ri][:, :, :, ci]


# ---------------------------------------------------------------------------
# get_dataset
# ---------------------------------------------------------------------------

_cache: Dict[Tuple, ArrayDataset] = {}


def get_dataset(name: str, transformer: str = 'default',
                splits: Sequence[str] = ('train', 'test'),
                size: Optional[int] = None,
                require_real: Optional[bool] = None):
    """-> (trainset, testset) (None for unrequested splits)
    (ref utils/torch_load.py:312-523).

    ``require_real=True`` (or env JVT_REQUIRE_REAL=1) raises
    FileNotFoundError instead of silently substituting synthetic data when
    the source files are absent under $JVT_DATA_DIR — for flagship parity
    runs that must not degrade quietly."""
    if require_real is None:
        require_real = os.environ.get('JVT_REQUIRE_REAL',
                                      '').lower() in ('1', 'true', 'yes')
    out = []
    for split in ('train', 'test'):
        if split not in splits:
            out.append(None)
            continue
        key = (name, transformer, split, size)
        if key not in _cache:
            _cache[key] = _build_split(name, transformer, split, size)
        ds = _cache[key]
        if require_real and ds.synthetic:
            raise FileNotFoundError(
                'dataset {}/{} not found under {} and require_real is set '
                '(see scripts/prepare_data.py for the expected layouts)'
                .format(name, split, DATA_DIR))
        out.append(ds)
    return tuple(out)


def _build_split(name: str, transformer: str, split: str,
                 size: Optional[int]) -> ArrayDataset:
    rotated = False
    base = name
    if name.endswith('90') and name not in dataset_properties():
        rotated = True
        base = name[:-2]

    parent, heldout = get_heldout_classes_by_name(base)
    props = dataset_properties().get(parent)
    if props is None:
        raise ValueError('unknown dataset {}'.format(name))
    shape = props['shape']
    classes = get_classes_by_name(base)
    num_labels = props['labels']

    synthetic = False
    if props.get('by_shape'):
        n = size or _DEFAULT_SIZES[split]
        seed = _stable_seed(parent, split)
        rng = np.random.default_rng(seed)
        if parent.startswith('const'):
            # constant-color images (ref ConstantDataset, torch_load.py:150)
            vals = rng.uniform(0, 1, size=(n, shape[0], 1, 1)).astype(np.float32)
            x = np.broadcast_to(vals, (n, *shape)).copy()
        elif parent.startswith('uniform'):
            # uniform noise (ref UniformDataset, torch_load.py:179)
            x = rng.uniform(0, 1, size=(n, *shape)).astype(np.float32)
        else:  # random300k-style numpy noise file (ref FromNumpy, :189)
            loaded = None
            for root in (os.path.join(DATA_DIR, '300k-random'),
                         os.path.join(DATA_DIR, parent)):
                loaded = loaded or _load_npy_dir(root, split, size)
            loaded = loaded or _load_npz(DATA_DIR, parent, split)
            if loaded is not None:
                x = loaded[0][:size] if size else loaded[0]
            else:
                x = rng.uniform(0, 1, size=(n, *shape)).astype(np.float32)
                synthetic = True
        y = np.zeros(len(x), np.int32)
    elif props.get('procedural'):
        x, y = _procedural_shapes(parent, shape, num_labels, split, size)
    else:
        # raw source set (mnist32p reads the mnist files then transforms)
        src = props.get('parent', parent)
        src_shape = dataset_properties().get(src, props)['shape']
        root = os.path.join(DATA_DIR, src)
        loaded = None
        if src in ('mnist', 'fashion', 'letters'):
            loaded = _load_mnist_like(root, split)
        if loaded is None and src.startswith('cifar'):
            loaded = (_load_cifar(root, split, want=src)
                      or _load_cifar(DATA_DIR, split, want=src))
        if loaded is None and src == 'svhn':
            loaded = _load_svhn_mat(root, split) or _load_svhn_mat(DATA_DIR,
                                                                   split)
        if loaded is None and src == 'dtd':
            loaded = _load_dtd(root, src_shape, split, size) \
                or _load_dtd(DATA_DIR, src_shape, split, size)
        if loaded is None and src.startswith('lsun'):
            loaded = _load_lsun(os.path.join(DATA_DIR, 'lsun'), src_shape,
                                split, mode=('resize' if src == 'lsunr'
                                             else 'crop'), size=size)
        if loaded is None:
            loaded = _load_npz(DATA_DIR, src, split)
        if loaded is None and (props.get('folder') or src.startswith(
                ('imagenet', 'dtd', 'lsun'))):
            loaded = _load_image_folder(
                props.get('folder') or root, src_shape, split,
                class_file=props.get('classes_from_file'))
        if loaded is None:
            x, y = _synthetic_fallback(src, src_shape, num_labels, split, size)
            synthetic = True
            logging.warning('dataset %s/%s not found under %s - using '
                            'deterministic synthetic substitute', src,
                            split, DATA_DIR)
        else:
            x, y = loaded

        x, y = _apply_transforms(x, y, props.get('pre_transform', ''),
                                 props.get('target_transform', ''), shape)
        if size:
            x, y = x[:size], y[:size]

    # transformer profiles (ref torch_load.py:416-423): 'pad' pads by 2
    # (matching get_shape_by_name(transform='pad')), 'crop' center-crops to
    # the registry shape
    if transformer == 'pad':
        x = np.pad(x, ((0, 0), (0, 0), (2, 2), (2, 2)))
    elif transformer == 'crop' and x.shape[2:] != tuple(shape[1:]):
        ch, cw = shape[1:]
        h0 = max(0, (x.shape[2] - ch) // 2)
        w0 = max(0, (x.shape[3] - cw) // 2)
        x = x[:, :, h0:h0 + ch, w0:w0 + cw]

    # heldout filtering + relabeling (ref torch_load.py:654-682)
    if heldout:
        kept = [c for c in range(num_labels) if c not in heldout]
        relabel = -np.ones(num_labels, np.int32)
        for new, old in enumerate(kept):
            relabel[old] = new
        m = np.isin(y, kept)
        x, y = x[m], relabel[y[m]]

    if rotated:
        x = np.transpose(x, (0, 1, 3, 2)).copy()

    ds = ArrayDataset(x, y, name, classes, transformer, heldout, synthetic,
                      same_size=get_same_size_by_name(base if not rotated
                                                      else base + '90'))
    return ds


def get_batch(dataset: ArrayDataset, batch_size: int = 100, seed=None):
    """One (shuffled) batch (ref get_batch, utils/torch_load.py:548-570)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(dataset), size=min(batch_size, len(dataset)),
                     replace=False)
    return to_float(dataset.data[idx]), dataset.targets[idx]


class DataLoader:
    """Seeded, epoch-shuffled batch iterator over an ArrayDataset, yielding
    host arrays (x float32, y int32), new arrays for every batch.

    Deterministic per (seed, epoch); optionally applies train-time
    augmentation (hflip / random crop of pad size // 8).  ``use_native``
    ('auto', True or 'always': the native batcher where it builds and
    the augmentation is flip/crop only, never over a memmap; False: numpy)
    follows the JAX package's loader; the numpy path augments on the host
    in one vectorized shot per batch, with edge padding."""

    def __init__(self, dataset: ArrayDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 data_augmentation: Sequence[str] = (),
                 drop_last: bool = False,
                 use_native='auto'):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.augmentation = list(data_augmentation)
        self.drop_last = drop_last
        self._native = None
        if (use_native in ('auto', True, 'always') and len(dataset)
                and all(a.startswith(('flip', 'hflip', 'crop'))
                        for a in self.augmentation)
                # the batcher holds a contiguous copy of the data, which
                # would defeat a memmap's bounded memory
                and not isinstance(dataset.data, np.memmap)):
            from . import native
            crop = (max(dataset.data.shape[-2] // 8, 1)
                    if any(a.startswith('crop')
                           for a in self.augmentation) else 0)
            flip = any(a.startswith(('flip', 'hflip'))
                       for a in self.augmentation)
            try:
                if native.available():
                    self._native = native.NativeBatcher(
                        dataset.data, dataset.targets, seed=seed,
                        hflip=flip, crop_pad=crop)
            except (OSError, RuntimeError) as e:
                logging.debug('native batcher disabled: %s', e)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        if self._native is not None:
            yield from self._iter_native()
            return
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

    def _iter_native(self):
        nb = self._native
        nb.start_epoch(self.epoch, self.shuffle)
        self.epoch += 1
        # new output arrays for every batch: callers (the engines'
        # recorders) keep a set's batches until its end
        for i in range(len(self)):
            yield nb.get_batch(i, self.batch_size)

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
