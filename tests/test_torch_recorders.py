"""The port's record files (``save_load/native_store.py``,
``save_load/recorders.py``) against the JAX package's: ``.jvr`` and
``.npz`` written by either package and read by the other, the Python
``.jvr`` writer byte-identical to the JAX package's native one, the
header probe and checksum, ``merge``, ``SampleRecorder`` and
``find_record``'s newest-wins rule."""

import os

import numpy as np
import pytest

from joint_vae_tpu.save_load import native_store as jstore
from joint_vae_tpu.save_load import recorders as jrec

from joint_vae_tpu_torch.save_load import native_store as tstore
from joint_vae_tpu_torch.save_load import recorders as trec


def _fill(cls, seed=0, batches=(8, 8, 5)):
    """A recorder of per-class losses (C, n), per-input losses (n,),
    logits stored (C, n) and labels, over a ragged last batch."""
    rng = np.random.default_rng(seed)
    r = cls.LossRecorder(8)
    r.init_seed_for_dataloader(3)
    for n in batches:
        r.append_batch(total=rng.standard_normal((4, n)).astype(np.float32),
                       iws=rng.standard_normal((4, n)).astype(np.float32),
                       cross_x=rng.standard_normal(n).astype(np.float32),
                       logits=rng.standard_normal((4, n)).astype(np.float32),
                       y_true=rng.integers(0, 4, n).astype(np.int32))
    return r


def _same(a, b):
    assert a.recorded_samples == b.recorded_samples == 21
    assert (a.batch_size, a.last_batch_size, a.restore_seed()) == (
        b.batch_size, b.last_batch_size, b.restore_seed())
    assert set(a.keys()) == set(b.keys())
    for k in a.keys():
        np.testing.assert_array_equal(a.get(k), b.get(k), err_msg=k)


@pytest.mark.parametrize('fmt', ['jvr', 'npz'])
@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_record_files_interchange(tmp_path, fmt, writer):
    src, dst = (trec, jrec) if writer == 'port' else (jrec, trec)
    path = str(tmp_path / 'record-set.{}'.format(fmt))
    _fill(src).save(path)
    _same(dst.LossRecorder.load(path), src.LossRecorder.load(path))
    if fmt == 'jvr':
        assert tstore.verify_jvr(path) and jstore.verify_jvr(path)


def test_python_writer_is_byte_identical(tmp_path, monkeypatch):
    """The port's Python writer and the JAX package's (native where it
    builds) write the same bytes; a corrupted byte fails the checksum."""
    r = _fill(trec)
    tensors = {k: r._tensors[k][..., :24] for k in r.keys()}
    args = (tensors, r.batch_size, len(r), r.last_batch_size, 3)
    a, b = str(tmp_path / 'a.jvr'), str(tmp_path / 'b.jvr')
    monkeypatch.setattr(tstore, 'get_lib', lambda: None)
    tstore.write_jvr(a, *args)
    jstore.write_jvr(b, *args)
    with open(a, 'rb') as f, open(b, 'rb') as g:
        raw = f.read()
        assert raw == g.read()
    meta = tstore.peek_jvr(a)
    assert meta['components'] == list(tensors) and meta['seed'] == 3
    assert tstore.verify_jvr(a)
    with open(a, 'r+b') as f:
        f.seek(meta['header_len'] + 5)
        f.write(bytes([raw[meta['header_len'] + 5] ^ 0xff]))
    assert not tstore.verify_jvr(a)


def test_native_writer_matches_python_writer(tmp_path, monkeypatch):
    """The port's two .jvr writers (the ctypes library and the Python
    fallback) write the same bytes, and ``sync`` changes none of them."""
    if tstore.get_lib() is None:
        pytest.skip('native/librecstore.so does not build here')
    r = _fill(trec, 4)
    args = ({k: r.get(k) for k in r.keys()}, r.batch_size, len(r),
            r.last_batch_size, None)
    paths = [str(tmp_path / '{}.jvr'.format(i)) for i in range(3)]
    tstore.write_jvr(paths[0], *args)
    tstore.write_jvr(paths[1], *args, sync=True)
    monkeypatch.setattr(tstore, 'get_lib', lambda: None)
    tstore.write_jvr(paths[2], *args)
    raw = [open(p, 'rb').read() for p in paths]
    assert raw[0] == raw[1] == raw[2]
    assert tstore.peek_jvr(paths[0])['seed'] is None


def test_merge_and_sample_recorder_match_jax(tmp_path):
    got = _fill(trec, 1).merge(_fill(trec, 2, (8, 3)))
    want = _fill(jrec, 1).merge(_fill(jrec, 2, (8, 3)))
    assert got.recorded_samples == want.recorded_samples == 32
    for k in want.keys():
        np.testing.assert_array_equal(got.get(k), want.get(k), err_msg=k)
    s = trec.SampleRecorder()
    s.append_batch(z=np.ones((2, 3)))
    s.append_batch(z=np.zeros((1, 3)))
    s.save(str(tmp_path / 's.npz'))
    np.testing.assert_array_equal(
        jrec.SampleRecorder.load(str(tmp_path / 's.npz')).get('z'),
        s.get('z'))


def test_find_record_newest_wins(tmp_path):
    d = str(tmp_path)
    assert trec.find_record(d, 'svhn') is None
    older, newer = (os.path.join(d, 'record-svhn.' + e) for e in ('npz', 'jvr'))
    _fill(trec).save(older)
    _fill(trec).save(newer)
    os.utime(older, (1, 1))
    assert trec.find_record(d, 'svhn') == jrec.find_record(d, 'svhn') == newer
    os.utime(newer, (0, 0))
    assert trec.find_record(d, 'svhn') == jrec.find_record(d, 'svhn') == older
    assert trec.record_filename('svhn') == jrec.record_filename('svhn')


def test_read_jvr_writeable_gives_private_copies(tmp_path):
    """``writeable=True`` returns copies and closes the memory map (the
    last view of the map no longer keeps it open)."""
    r = _fill(trec, 5)
    path = str(tmp_path / 'record-set.jvr')
    r.save(path)
    meta, arrays = tstore.read_jvr(path, writeable=True)
    assert meta['recorded_batches'] == 3 and set(arrays) == set(r.keys())
    for k in r.keys():         # stored over whole batches: 3 x 8 samples
        np.testing.assert_array_equal(arrays[k][..., :21], r.get(k),
                                      err_msg=k)
        assert arrays[k].flags.writeable
    arrays['iws'][...] = 0.0
    np.testing.assert_array_equal(trec.LossRecorder.load(path).get('iws'),
                                  r.get('iws'))
