#!/usr/bin/env python
"""Data preparation / verification for $JVT_DATA_DIR, for the PyTorch
port: ``scripts/prepare_data.py`` with ``verify`` reading through the
port's loaders (``joint_vae_tpu_torch/data/loaders.py``); the LSUN export
and the fixture writer are copies of that script's, so the fixtures are
the same bytes.

The loaders read whole-array datasets from ``$JVT_DATA_DIR`` (default
``./data``) in the reference's on-disk formats (ref utils/torch_load.py
getters + data/sets.ini roots):

    mnist/                      idx files: train-images-idx3-ubyte[.gz], ...
    fashion/                    same idx layout (FashionMNIST)
    letters/                    same idx layout (EMNIST letters split)
    cifar-10-batches-py/        python pickles (data_batch_1..5, test_batch)
    cifar-100-python/           python pickles (train, test)
    svhn/                       train_32x32.mat, test_32x32.mat
    dtd/dtd/{images,labels}/    torchvision DTD layout; 'test' = test1+val1
    lsun/<category>_<split>/    exported images, OR <category>_<split>_lmdb
    300k-random/test/*.npy      one (N, 32, 32, 3) uint8 array (random300k)
    imagenet12/<split>/<wnid>/  ImageFolder; imagenet1k/20/2 restrict classes
                                via data/imagenet{1k,20,2}.txt
    <name>-<split>.npz          generic fallback: arrays 'x' [+ 'y']

Subcommands:
    verify            try to load every registered real set and report which
                      resolve to real files vs the synthetic fallback
    export-lsun       convert LSUN lmdb databases to image folders (requires
                      the ``lmdb`` module)
    make-fixtures     write tiny synthetic fixture files in every supported
                      format (for loader self-tests and
                      ``scripts/torch_reproduce_sota.py --fixtures``)

    python scripts/torch_prepare_data.py verify --data-dir ./data
    python scripts/torch_prepare_data.py make-fixtures --data-dir /tmp/fx

Nothing is downloaded: fetch the archives on a connected machine
(torchvision download=True produces exactly these layouts) and copy the
tree here.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def cmd_verify(args):
    os.environ.setdefault('JVT_DATA_DIR', args.data_dir)
    from joint_vae_tpu_torch.data import loaders
    from joint_vae_tpu_torch.data.registry import dataset_properties
    loaders.DATA_DIR = args.data_dir
    names = [n for n, p in dataset_properties().items()
             if not p.get('procedural') and not n.startswith(('const',
                                                              'uniform'))]
    rows = []
    for n in names:
        try:
            _, ts = loaders.get_dataset(n, splits=['test'], size=64)
            rows.append((n, 'SYNTHETIC-FALLBACK' if ts.synthetic else
                         'real ({} items)'.format(len(ts))))
        except Exception as e:
            rows.append((n, 'ERROR: {}'.format(e)))
    w = max(len(n) for n, _ in rows)
    for n, s in rows:
        print('{:{w}}  {}'.format(n, s, w=w))
    return 0


def cmd_export_lsun(args):
    try:
        import lmdb
    except ImportError:
        print('the lmdb module is not installed; export on a machine that '
              'has it, then rsync the folders', file=sys.stderr)
        return 1
    import io
    from PIL import Image
    root = args.root
    for db in sorted(os.listdir(root)):
        if not db.endswith('_lmdb'):
            continue
        out = os.path.join(root, db[:-len('_lmdb')])
        os.makedirs(out, exist_ok=True)
        env = lmdb.open(os.path.join(root, db), readonly=True, lock=False)
        with env.begin() as txn:
            for i, (_, buf) in enumerate(txn.cursor()):
                if args.limit and i >= args.limit:
                    break
                Image.open(io.BytesIO(buf)).convert('RGB').save(
                    os.path.join(out, '{:07d}.jpg'.format(i)), quality=92)
        print('exported', db, '->', out)
    return 0


def cmd_make_fixtures(args):
    """Tiny files in every supported format, for loader self-tests."""
    import numpy as np
    import scipy.io
    from PIL import Image
    d = args.data_dir
    rng = np.random.default_rng(0)

    # cifar-10 python-pickle batches (5 train batches + test_batch)
    import pickle
    b10 = os.path.join(d, 'cifar10', 'cifar-10-batches-py')
    os.makedirs(b10, exist_ok=True)
    for fn, n in [('data_batch_{}'.format(i), 8) for i in range(1, 6)] + [
            ('test_batch', 16)]:
        with open(os.path.join(b10, fn), 'wb') as f:
            pickle.dump({b'data': rng.integers(0, 255, (n, 3072),
                                               dtype=np.uint8),
                         b'labels': rng.integers(0, 10, n).tolist()}, f)

    # svhn .mat
    os.makedirs(os.path.join(d, 'svhn'), exist_ok=True)
    for split, n in (('train', 12), ('test', 8)):
        scipy.io.savemat(
            os.path.join(d, 'svhn', '{}_32x32.mat'.format(split)),
            {'X': rng.integers(0, 255, (32, 32, 3, n), dtype=np.uint8),
             'y': rng.integers(1, 11, (n, 1), dtype=np.uint8)})

    # random300k .npy
    os.makedirs(os.path.join(d, '300k-random', 'test'), exist_ok=True)
    np.save(os.path.join(d, '300k-random', 'test', 'imgs.npy'),
            rng.integers(0, 255, (16, 32, 32, 3), dtype=np.uint8))

    # dtd folder + label lists
    for cls in ('banded', 'dotted'):
        cdir = os.path.join(d, 'dtd', 'dtd', 'images', cls)
        os.makedirs(cdir, exist_ok=True)
        for i in range(3):
            arr = rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
            Image.fromarray(arr).save(
                os.path.join(cdir, '{}_{:04d}.jpg'.format(cls, i)))
    ldir = os.path.join(d, 'dtd', 'dtd', 'labels')
    os.makedirs(ldir, exist_ok=True)
    for fn, idx in (('train1.txt', [0]), ('test1.txt', [1]),
                    ('val1.txt', [2])):
        with open(os.path.join(ldir, fn), 'w') as f:
            for cls in ('banded', 'dotted'):
                for i in idx:
                    f.write('{}/{}_{:04d}.jpg\n'.format(cls, cls, i))

    # lsun exported folders
    for cat in ('bedroom', 'church'):
        for split in ('train', 'test'):
            cdir = os.path.join(d, 'lsun', '{}_{}'.format(cat, split))
            os.makedirs(cdir, exist_ok=True)
            for i in range(2):
                arr = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                Image.fromarray(arr).save(
                    os.path.join(cdir, '{:04d}.jpg'.format(i)))

    # mnist/fashion/letters idx files — byte-exact ubyte format
    # (ref torchvision MNIST raw layout); the train split uses the .gz
    # variant and the test split the raw one so both reader codepaths
    # (data/loaders.py::_read_idx) get exercised
    import gzip
    import struct

    def write_idx(path, arr):
        op = gzip.open if path.endswith('.gz') else open
        with op(path, 'wb') as f:
            f.write(struct.pack('>I', 0x0800 + arr.ndim))
            f.write(struct.pack('>' + 'I' * arr.ndim, *arr.shape))
            f.write(arr.astype(np.uint8).tobytes())

    for name, n_cls, lo in (('mnist', 10, 0), ('fashion', 10, 0),
                            ('letters', 26, 1)):     # EMNIST letters: 1..26
        root = os.path.join(d, name)
        os.makedirs(root, exist_ok=True)
        for prefix, n, ext in (('train', 12, '.gz'), ('t10k', 8, '')):
            write_idx(os.path.join(
                root, '{}-images-idx3-ubyte{}'.format(prefix, ext)),
                rng.integers(0, 255, (n, 28, 28), dtype=np.uint8))
            write_idx(os.path.join(
                root, '{}-labels-idx1-ubyte{}'.format(prefix, ext)),
                rng.integers(lo, lo + n_cls, (n,), dtype=np.uint8))

    # cifar-100 python pickle (fine_labels key, one file per split)
    b100 = os.path.join(d, 'cifar100', 'cifar-100-python')
    os.makedirs(b100, exist_ok=True)
    for fn, n in (('train', 12), ('test', 8)):
        with open(os.path.join(b100, fn), 'wb') as f:
            pickle.dump({b'data': rng.integers(0, 255, (n, 3072),
                                               dtype=np.uint8),
                         b'fine_labels': rng.integers(0, 100, n).tolist()},
                        f)

    # ImageFolder restricted by wnid class file (imagenet2; ref
    # ImageFolderWithClassesInFile, utils/torch_load.py:250-294) — plus a
    # decoy class NOT in data/imagenet2.txt that the reader must skip
    for split, n in (('train', 3), ('val', 2)):
        for wnid in ('n03657121', 'n07697313', 'n99999999'):
            cdir = os.path.join(d, 'imagenet2', split, wnid)
            os.makedirs(cdir, exist_ok=True)
            for i in range(n):
                arr = rng.integers(0, 255, (64, 48, 3), dtype=np.uint8)
                Image.fromarray(arr).save(
                    os.path.join(cdir, '{}_{}.JPEG'.format(wnid, i))
                    .replace('.JPEG', '.jpg'))
    print('fixtures written under', d)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    sub = p.add_subparsers(dest='cmd', required=True)
    v = sub.add_parser('verify')
    v.add_argument('--data-dir', default=os.environ.get('JVT_DATA_DIR',
                                                        './data'))
    e = sub.add_parser('export-lsun')
    e.add_argument('--root', default='./data/lsun')
    e.add_argument('--limit', type=int, default=0)
    f = sub.add_parser('make-fixtures')
    f.add_argument('--data-dir', required=True)
    args = p.parse_args(argv)
    return {'verify': cmd_verify, 'export-lsun': cmd_export_lsun,
            'make-fixtures': cmd_make_fixtures}[args.cmd](args)


if __name__ == '__main__':
    sys.exit(main())
