"""The port's native batcher binding (``data/native.py``) and the loader that
takes it, against the JAX package's, over the same ``native/batcher.cpp``
library: for the same seed, epoch, flip and crop, equal arrays from the
batcher and from ``DataLoader(use_native='auto')``, on float and uint8
sets; fresh arrays for every batch; and the JAX rules for when the loader
takes the batcher (flip and crop only, never over a memmap).  Skipped
where the library does not build (no compiler)."""

import time

import numpy as np
import pytest

from joint_vae_tpu.data import loaders as jloaders
from joint_vae_tpu.data import native as jnative

from joint_vae_tpu_torch.data import loaders as tloaders
from joint_vae_tpu_torch.data import native as tnative


@pytest.fixture
def lib():
    for _ in range(40):
        try:
            if jnative.get_lib() is None or tnative.get_lib() is None:
                pytest.skip('native/libjvtbatcher.so does not build here '
                            '(no g++)')
            return
        except OSError:       # another test process is still writing it
            time.sleep(0.25)
    pytest.fail('native/libjvtbatcher.so does not load')


def _data(kind, n=37, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 5, n).astype(np.int32)
    if kind == 'uint8':
        return rng.integers(0, 256, (n, 3, 8, 8)).astype(np.uint8), y
    return rng.uniform(0, 1, (n, 3, 8, 8)).astype(np.float32), y


CASES = {'plain': dict(), 'flip': dict(hflip=True),
         'flip_crop': dict(hflip=True, crop_pad=1)}


@pytest.mark.parametrize('kind', ['float', 'uint8'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_batcher_matches_jax(lib, kind, case):
    x, y = _data(kind)
    kw = CASES[case]
    jb = jnative.NativeBatcher(x, y, seed=11, **kw)
    tb = tnative.NativeBatcher(x, y, seed=11, **kw)
    assert tb.shape == jb.shape and tb.n == jb.n == 37
    for epoch in (0, 3):
        jb.start_epoch(epoch)
        tb.start_epoch(epoch)
        for i in range(4):
            jx, jy = jb.get_batch(i, 10)
            tx, ty = tb.get_batch(i, 10)
            assert tx.dtype == np.float32 and len(tx) == (7 if i == 3 else 10)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
        with pytest.raises(IndexError):
            tb.get_batch(4, 10)


@pytest.mark.parametrize('kind', ['float', 'uint8'])
@pytest.mark.parametrize('aug', [[], ['flip'], ['flip', 'crop']],
                         ids=['none', 'flip', 'flip_crop'])
def test_loader_takes_the_batcher_as_jax(lib, kind, aug):
    x, y = _data(kind)
    jl = jloaders.DataLoader(jloaders.ArrayDataset(x, y, 's'), 8, seed=4,
                             data_augmentation=aug, drop_last=True)
    tl = tloaders.DataLoader(tloaders.ArrayDataset(x, y, 's'), 8, seed=4,
                             data_augmentation=aug, drop_last=True)
    assert jl._native is not None and tl._native is not None
    assert len(tl) == len(jl) == 4
    for _ in range(2):                       # two epochs
        got = list(tl)
        for (jx, jy), (tx, ty) in zip(jl, got):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
        # new arrays every batch: a kept batch is not overwritten
        assert len({b[0].ctypes.data for b in got}) == len(got)
    ev = tloaders.DataLoader(tloaders.ArrayDataset(x, y, 's'), 16,
                             shuffle=False)
    got = list(ev)
    assert [len(b[1]) for b in got] == [16, 16, 5]
    np.testing.assert_array_equal(np.concatenate([b[1] for b in got]), y)
    np.testing.assert_array_equal(np.concatenate([b[0] for b in got]),
                                  tloaders.to_float(x))


def test_loader_rules_match_jax(lib, tmp_path):
    """No batcher for other augmentations, over a memmap, or when asked."""
    x, y = _data('uint8')
    path = str(tmp_path / 'x.u8')
    mm = np.memmap(path, np.uint8, 'w+', shape=x.shape)
    mm[:] = x
    for data, aug, use in ((x, ['rotate'], 'auto'), (mm, [], 'auto'),
                           (x, [], False)):
        for loaders in (jloaders, tloaders):
            dl = loaders.DataLoader(loaders.ArrayDataset(data, y, 's'), 8,
                                    data_augmentation=aug, use_native=use)
            assert dl._native is None


def test_no_compiler_takes_the_numpy_path(monkeypatch):
    monkeypatch.setattr(tnative, 'available', lambda: False)
    x, y = _data('float')
    dl = tloaders.DataLoader(tloaders.ArrayDataset(x, y, 's'), 8, seed=4,
                             data_augmentation=['flip'])
    assert dl._native is None
    want = jloaders.DataLoader(jloaders.ArrayDataset(x, y, 's'), 8, seed=4,
                               data_augmentation=['flip'], use_native=False)
    for (a, b), (c, d) in zip(dl, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
