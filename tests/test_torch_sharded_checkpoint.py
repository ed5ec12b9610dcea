"""The port's sharded checkpoint writer (``jvt-sharded-v1``) against the
JAX package's reader and writer.

- a (data 2, model 2) run of 4 gloo ranks saves its job: JAX's
  ``load_checkpoint_sharded`` reads every array bit for bit, JAX's
  ``load_job`` loads the job, each class-split chunk comes from the
  'data'-index-0 rank of its model column and everything else from rank
  0, and rank 0 alone writes the JSON files;
- that checkpoint restores onto a (1, 2) mesh and trains on, saved through
  an ``AsyncCheckpointer``, as one process resuming it does;
- a JAX sharded ``save_job`` loads in the port;
- ``AsyncCheckpointer`` overlaps and re-raises; an incomplete shard
  directory raises; bfloat16 leaves are stored as their 16-bit words; a
  switch of format removes the other one.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from joint_vae_tpu.parallel.mesh import ensure_placed as jax_ensure_placed
from joint_vae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.save_load import sharded_checkpoint as jsc
from joint_vae_tpu.train.optimizers import OptimizerConfig as JOptimizerConfig

from joint_vae_tpu_torch.models.cvnet import CVNet
from joint_vae_tpu_torch.parallel.mesh import Mesh
from joint_vae_tpu_torch.save_load import sharded_checkpoint as tsc
from joint_vae_tpu_torch.save_load.checkpoint import load_arrays
from joint_vae_tpu_torch.save_load.from_jax import (opt_state_to_jax,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.save_load.jobs import load_job, save_job
from joint_vae_tpu_torch.train import trainer
from joint_vae_tpu_torch.utils.print_log import EpochOutput

import torch_mp_worker as W
from torch_port_util import mesh_cfg as jax_cfg
from torch_port_util import port_cfg


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    """A JAX-made job trained 2 epochs on a (2, 2) mesh and saved."""
    root = tmp_path_factory.mktemp('ckpt')
    d = str(root / 'src')
    jjobs.save_job(jjobs.new_job(jax_cfg(), JOptimizerConfig(lr=3e-3),
                                 key=jax.random.PRNGKey(0)), d)
    res = W.launch('train', 4, str(root / 'run'), job_dir=d, model_axis=2,
                   n_train=64, epochs=2, batch_size=16, save=str(root))
    return str(root / 'job'), res


def _port_arrays(weights, cfg):
    model = CVNet(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()},
                          strict=False)
    return state_dict_to_jax(model)


def test_jax_reads_the_port_checkpoint_bit_for_bit(saved):
    job_dir, res = saved
    got = jsc.load_checkpoint_sharded(os.path.join(job_dir, 'state.shards'))
    port = tsc.load_checkpoint_sharded(os.path.join(job_dir, 'state.shards'))
    cfg = load_job(job_dir, ghost=True).model_cfg
    want = _port_arrays(res[0]['weights'], cfg)
    for k, v in want.items():
        if k.startswith('params/'):
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    for k in got:
        np.testing.assert_array_equal(port[k], got[k], err_msg=k)
    assert int(got['counters/step']) == 8 and int(got['counters/epoch']) == 1
    # and JAX loads the job
    jjob = jjobs.load_job(job_dir)
    assert jjob.trained == 2
    np.testing.assert_array_equal(
        np.asarray(jjob.state.params['prior']['mean']),
        got['params/prior/mean'])


def test_one_writer_per_chunk_and_json_from_rank_0(saved):
    job_dir, res = saved
    sdir = os.path.join(job_dir, 'state.shards')
    with open(os.path.join(sdir, 'manifest.json')) as f:
        man = json.load(f)
    assert man['format'] == 'jvt-sharded-v1' and man['process_count'] == 4
    assert man['leaves']['params/prior/mean']['shape'] == [4, 8]
    assert man['leaves']['params/classifier/head/kernel']['shape'] == [8, 4]
    keys = {}
    for r in range(4):
        with np.load(os.path.join(sdir, 'shard-{}.npz'.format(r))) as z:
            keys[r] = set(z.files)
    # ranks 2 and 3 sit at 'data' index 1: they write nothing
    assert keys[2] == keys[3] == set()
    assert 'params/prior/mean@0,0' in keys[0]
    assert 'params/prior/mean@2,0' in keys[1]
    assert 'params/classifier/head/kernel@0,2' in keys[1]
    assert 'params/classifier/head/bias@2' in keys[1]
    assert not any(k.startswith('params/encoder') for k in keys[1])
    assert 'counters/step@' in keys[0]
    assert res[0]['json_writes'] > 0
    assert [r['json_writes'] for r in res[1:]] == [0, 0, 0]
    assert not os.path.exists(os.path.join(job_dir, 'state.npz'))


def test_restore_onto_another_mesh_through_the_async_writer(saved, tmp_path):
    """The (2, 2) checkpoint restores onto a (1, 2) mesh, trains an epoch
    and saves through an AsyncCheckpointer: as one process resuming it."""
    job_dir, _ = saved
    out = str(tmp_path / 'next')
    res = W.launch('ckpt', 2, str(tmp_path / 'run'), job_dir=job_dir,
                   model_axis=2, n_train=64, batch_size=16, out_dir=out,
                   **{'async': True})
    job = load_job(job_dir, device='cpu')
    trainer.train_model(job, W.dataset(64, 1), None, epochs=3,
                        batch_size=16, outputs=EpochOutput(stdout=False),
                        seed=3)
    np.testing.assert_allclose(res[0]['history'][3]['train_loss']['total'],
                               job.train_history[3]['train_loss']['total'],
                               rtol=1e-6)
    back = load_job(out, device='cpu')
    assert back.trained == 3
    mine = state_dict_to_jax(job.model)
    for k, v in state_dict_to_jax(back.model).items():
        np.testing.assert_allclose(v, mine[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    a = opt_state_to_jax(back.model, back.opt_cfg, back.state.opt_state)
    b = opt_state_to_jax(job.model, job.opt_cfg, job.state.opt_state)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_jax_sharded_save_job_loads_in_the_port(tmp_path):
    jjob = jjobs.new_job(jax_cfg(), JOptimizerConfig(lr=3e-3),
                         key=jax.random.PRNGKey(1))
    mesh = jax_make_mesh(8, model_axis=2)
    jjob.state = jax_ensure_placed(jjob.state, mesh)
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d, sharded=True)
    assert os.path.isdir(os.path.join(d, 'state.shards'))
    tjob = load_job(d, device='cpu')
    want = jsc.load_checkpoint_sharded(os.path.join(d, 'state.shards'))
    for k, v in state_dict_to_jax(tjob.model).items():
        assert v.tobytes() == want[k].tobytes(), k
    opt = jsc.load_checkpoint_sharded(os.path.join(d, 'optimizer.shards'))
    got = opt_state_to_jax(tjob.model, tjob.opt_cfg, tjob.state.opt_state)
    for k, v in got.items():
        np.testing.assert_array_equal(v, opt[k], err_msg=k)


def _job(device='cpu'):
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    return new_job(port_cfg(jax_cfg()), OptimizerConfig(lr=3e-3), seed=2,
                   device=device)


def test_async_checkpointer_overlaps_and_reraises(tmp_path):
    ck = tsc.AsyncCheckpointer()
    started, release = threading.Event(), threading.Event()

    def slow():
        started.set()
        release.wait(10)
    t0 = time.time()
    ck.submit(slow)
    started.wait(10)
    assert time.time() - t0 < 5            # submit did not wait for it
    release.set()
    ck.wait()

    def boom():
        raise RuntimeError('disk full')
    ck.submit(boom)
    with pytest.raises(RuntimeError, match='disk full'):
        ck.wait()
    ck.submit(boom)
    with pytest.raises(RuntimeError, match='disk full'):
        ck.submit(lambda: None)            # the next submit re-raises
    ck.wait()


def test_async_save_writes_a_snapshot(tmp_path, monkeypatch):
    """The async save snapshots the tensors when it is submitted: an
    in-place update while the worker is still held does not reach the
    files, which equal a synchronous save's bytes."""
    from joint_vae_tpu_torch.save_load.jobs import opt_leaves
    job = _job()
    st = job.state
    sync, late = str(tmp_path / 'sync'), str(tmp_path / 'async')
    tsc.save_checkpoint_sharded(sync, opt_leaves(job.model, job.opt_cfg,
                                                 st.opt_state))
    gate = threading.Event()
    real = tsc._write_npz
    monkeypatch.setattr(tsc, '_write_npz',
                        lambda *a: gate.wait(10) and real(*a))
    ck = tsc.AsyncCheckpointer()
    tsc.save_checkpoint_sharded(late, opt_leaves(job.model, job.opt_cfg,
                                                 st.opt_state),
                                checkpointer=ck, sync=False)
    with torch.no_grad():
        for v in st.opt_state.mu.values():
            v.add_(1.0)
    gate.set()
    ck.wait()
    a = tsc.load_checkpoint_sharded(sync)
    b = tsc.load_checkpoint_sharded(late)
    assert set(a) == set(b) and any('/mu/' in k for k in a)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_async_save_job_returns_before_its_one_write(tmp_path, monkeypatch):
    """``save_job`` through an AsyncCheckpointer returns while its writes
    are held: the state, the optimizer and the removal of the npz
    archives run as one write on the worker, from the tensors as they
    were at the submit."""
    from joint_vae_tpu_torch.save_load.jobs import (opt_leaves,
                                                     state_leaves)
    job = _job()
    d = str(tmp_path / 'job')
    save_job(job, d)
    want = {**tsc.load_checkpoint_sharded(_sync_copy(
        tmp_path / 'st', state_leaves(job.state))),
        **tsc.load_checkpoint_sharded(_sync_copy(
            tmp_path / 'op', opt_leaves(job.model, job.opt_cfg,
                                        job.state.opt_state)))}
    gate, writes = threading.Event(), []
    real = tsc._write_npz

    def held(*a):
        gate.wait(10)
        writes.append(a[0])
        return real(*a)
    monkeypatch.setattr(tsc, '_write_npz', held)
    ck = tsc.AsyncCheckpointer()
    save_job(job, d, sharded=True, checkpointer=ck)
    assert writes == [] and os.path.exists(os.path.join(d, 'state.npz'))
    with torch.no_grad():
        for p in job.model.parameters():
            p.add_(1.0)
        for v in job.state.opt_state.mu.values():
            v.add_(1.0)
    gate.set()
    ck.wait()
    assert [os.path.basename(os.path.dirname(w)) for w in writes] == [
        'state.shards', 'optimizer.shards']
    assert not os.path.exists(os.path.join(d, 'state.npz'))
    assert not os.path.exists(os.path.join(d, 'optimizer.npz'))
    got = {**tsc.load_checkpoint_sharded(os.path.join(d, 'state.shards')),
           **tsc.load_checkpoint_sharded(os.path.join(d, 'optimizer.shards'))}
    assert set(got) == set(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def _sync_copy(path, leaves):
    tsc.save_checkpoint_sharded(str(path), leaves)
    return str(path)


def test_incomplete_shard_directory_raises(tmp_path):
    """Rank 0 of a world of 2 alone: the manifest expects shard-1."""
    job = _job()
    from joint_vae_tpu_torch.save_load.jobs import state_leaves
    d = str(tmp_path / 'state.shards')
    tsc.save_checkpoint_sharded(d, state_leaves(job.state),
                                mesh=Mesh({'data': 2, 'model': 1}, rank=0),
                                sync=False)
    with pytest.raises(FileNotFoundError, match='shard-1.npz'):
        tsc.load_checkpoint_sharded(d)
    with pytest.raises(FileNotFoundError, match='shard-1.npz'):
        jsc.load_checkpoint_sharded(d)


def test_bfloat16_leaves_are_stored_as_words(tmp_path):
    t = torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)
    d = str(tmp_path / 'x.shards')
    tsc.save_checkpoint_sharded(d, {'a/b': tsc.Leaf(t)})
    with np.load(os.path.join(d, 'shard-0.npz')) as z:
        assert z['a/b@0'].dtype == np.uint16
    with open(os.path.join(d, 'manifest.json')) as f:
        assert json.load(f)['leaves']['a/b']['dtype'] == 'bfloat16'
    np.testing.assert_array_equal(tsc.load_checkpoint_sharded(d)['a/b'],
                                  t.float().numpy())
    got = jsc.load_checkpoint_sharded(d)['a/b']
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  t.float().numpy())


def test_a_format_switch_removes_the_other(tmp_path, monkeypatch):
    job = _job()
    d = str(tmp_path / 'job')
    save_job(job, d)
    assert os.path.exists(os.path.join(d, 'state.npz'))
    monkeypatch.setenv('JVT_SHARDED_CKPT', '1')
    save_job(job, d)
    assert not os.path.exists(os.path.join(d, 'state.npz'))
    assert tsc.is_sharded_checkpoint(os.path.join(d, 'state.shards'))
    a = state_dict_to_jax(load_job(d, device='cpu').model)
    monkeypatch.delenv('JVT_SHARDED_CKPT')
    save_job(job, d)
    assert not os.path.exists(os.path.join(d, 'state.shards'))
    b = load_arrays(os.path.join(d, 'state.npz'))
    for k, v in a.items():
        assert v.tobytes() == b[k].tobytes(), k
