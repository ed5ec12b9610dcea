"""The port's ImageFolder ingest cache (``data/ingest.py``) against the JAX
package's, on a tiny PNG tree: the same files under the same names, byte
for byte (serial and through the decode workers); each package opens the
other's cache without decoding; touching a file invalidates the cache; a
split-structured tree never falls back to its root; a decode worker that
dies without a word fails the ingest and leaves no complete cache; the
loader's ``JVT_INGEST_CACHE`` switch; and the worker imports nothing but
numpy and PIL."""

import ast
import os
import shutil

import numpy as np
import pytest

PIL = pytest.importorskip('PIL')
from PIL import Image

from joint_vae_tpu.data import ingest as jingest
from joint_vae_tpu.data import loaders as jloaders

from joint_vae_tpu_torch.data import ingest as tingest
from joint_vae_tpu_torch.data import loaders as tloaders

SHAPE = (3, 8, 8)


def _make_tree(root, n_per_class=6, classes=('cat', 'dog'), seed=0):
    rng = np.random.default_rng(seed)
    for c in classes:
        d = os.path.join(root, c)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_class):
            arr = rng.integers(0, 256, (10, 10, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, 'im{:03d}.png'.format(i)))
    return root


def _cache_files(base):
    d = os.path.join(base, '.jvt_cache')
    return {f: open(os.path.join(d, f), 'rb').read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize('workers,chunk', [(1, 1000), (2, 4)],
                         ids=['serial', 'workers'])
def test_cache_bytes_equal_jax(tmp_path, workers, chunk):
    a = _make_tree(str(tmp_path / 'a' / 'tree'), n_per_class=10)
    b = _make_tree(str(tmp_path / 'b' / 'tree'), n_per_class=10)
    for d in (a, b):          # equal trees, equal mtimes: equal cache keys
        for c in ('cat', 'dog'):
            for f in os.listdir(os.path.join(a, c)):
                os.utime(os.path.join(d, c, f), ns=(10 ** 18, 10 ** 18))
    jx, jy, jc = jingest.ingest_image_folder(a, SHAPE, workers=workers,
                                             chunk=chunk)
    tx, ty, tc = tingest.ingest_image_folder(b, SHAPE, workers=workers,
                                             chunk=chunk)
    assert isinstance(tx, np.memmap) and tx.dtype == np.uint8
    assert tc == jc == ['cat', 'dog']
    np.testing.assert_array_equal(np.asarray(tx), np.asarray(jx))
    np.testing.assert_array_equal(ty, jy)
    fa, fb = _cache_files(a), _cache_files(b)
    assert sorted(fa) == sorted(fb) and len(fa) == 3
    for name in fa:
        if name.endswith('.json'):       # holds the tree's absolute path
            continue
        assert fa[name] == fb[name], name
    np.testing.assert_array_equal(
        np.asarray(tx[0]),
        tingest.decode_one(os.path.join(b, 'cat', 'im000.png'), SHAPE))


def test_each_package_opens_the_others_cache(tmp_path, monkeypatch):
    for name, (make, read, other) in {
            'port_reads_jax': (jingest, tingest, tingest),
            'jax_reads_port': (tingest, jingest, jingest)}.items():
        base = _make_tree(str(tmp_path / name))
        x, y, classes = make.ingest_image_folder(base, SHAPE)

        def boom(*a, **k):
            raise AssertionError('decoded on a warm cache')
        monkeypatch.setattr(other, '_decode_one' if other is jingest
                            else 'decode_one', boom)
        got = read.open_cached_image_folder(base, SHAPE)
        assert got is not None, name
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(x))
        np.testing.assert_array_equal(got[1], y)
        gx, gy, gc = read.ingest_image_folder(base, SHAPE)
        assert gc == classes
        np.testing.assert_array_equal(np.asarray(gx), np.asarray(x))
        monkeypatch.undo()


def test_touching_a_file_invalidates_the_cache(tmp_path, monkeypatch):
    base = _make_tree(str(tmp_path / 'tree'))
    tingest.ingest_image_folder(base, SHAPE)
    assert tingest.open_cached_image_folder(base, SHAPE) is not None
    p = os.path.join(base, 'cat', 'im000.png')
    st = os.stat(p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert tingest.open_cached_image_folder(base, SHAPE) is None
    calls = []
    real = tingest.decode_one
    monkeypatch.setattr(tingest, 'decode_one',
                        lambda *a: calls.append(1) or real(*a))
    x, _, _ = tingest.ingest_image_folder(base, SHAPE)
    assert len(calls) == 12 and len(x) == 12
    # a cache whose .u8 a cleaner removed is a miss, not a crash
    u8 = [f for f in os.listdir(os.path.join(base, '.jvt_cache'))
          if f.endswith('.u8')]
    for f in u8:
        os.unlink(os.path.join(base, '.jvt_cache', f))
    assert tingest.open_cached_image_folder(base, SHAPE) is None


def test_split_tree_never_falls_back_to_root(tmp_path):
    root = str(tmp_path / 'tree')
    _make_tree(os.path.join(root, 'test'), n_per_class=2)
    for loaders in (jloaders, tloaders):
        assert loaders._load_image_folder(root, SHAPE, 'train') is None
        got = loaders._load_image_folder(root, SHAPE, 'test')
        assert got is not None and len(got[0]) == 4


def test_loader_cache_switch_matches_jax(tmp_path, monkeypatch):
    a = str(tmp_path / 'a')
    _make_tree(a)
    b = str(tmp_path / 'b')
    shutil.copytree(a, b)
    jx, jy = jloaders._load_image_folder(a, SHAPE, 'train')
    tx, ty = tloaders._load_image_folder(b, SHAPE, 'train')
    assert isinstance(tx, np.memmap) and tx.dtype == np.uint8
    assert os.path.isdir(os.path.join(b, '.jvt_cache'))
    np.testing.assert_array_equal(np.asarray(tx), np.asarray(jx))
    np.testing.assert_array_equal(ty, jy)
    monkeypatch.setenv('JVT_INGEST_CACHE', 'off')
    c = str(tmp_path / 'c')
    shutil.copytree(a, c, ignore=shutil.ignore_patterns('.jvt_cache'))
    dx, dy = tloaders._load_image_folder(c, SHAPE, 'train')
    assert not isinstance(dx, np.memmap) and dx.dtype == np.uint8
    assert not os.path.exists(os.path.join(c, '.jvt_cache'))
    np.testing.assert_array_equal(dx, np.asarray(jx))
    np.testing.assert_array_equal(dy, jy)


def test_silent_worker_death_poisons_ingest(tmp_path, monkeypatch):
    """A worker killed without output (OOM kill, segfault) fails the
    ingest: no complete cache with a zero slice is presented."""
    import subprocess

    base = _make_tree(str(tmp_path / 'tree'), n_per_class=10)

    class DeadPopen:
        returncode = -9

        def __init__(self, *a, **kw):
            pass

        def communicate(self, timeout=None):
            return '', None

    monkeypatch.setattr(subprocess, 'Popen', DeadPopen)
    with pytest.raises(RuntimeError, match='decode worker exited -9'):
        tingest.ingest_image_folder(base, SHAPE, workers=2, chunk=4)
    left = os.listdir(os.path.join(base, '.jvt_cache'))
    assert not any(f.endswith(('.u8', '.json')) for f in left), left
    monkeypatch.undo()
    x, _, _ = tingest.ingest_image_folder(base, SHAPE, workers=2, chunk=4)
    assert len(x) == 20 and np.asarray(x).sum() > 0


def test_worker_reports_a_bad_file(tmp_path):
    base = _make_tree(str(tmp_path / 'tree'), n_per_class=10)
    with open(os.path.join(base, 'dog', 'im003.png'), 'wb') as f:
        f.write(b'not an image')
    with pytest.raises(RuntimeError, match='im003.png'):
        tingest.ingest_image_folder(base, SHAPE, workers=2, chunk=4)


def test_worker_imports_only_numpy_and_pil():
    with open(tingest.WORKER) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split('.')[0])
    assert roots == {'json', 'sys', 'numpy', 'PIL'}
