"""The port's job store: the model registry (``save_load/fetch.py``), job
loading (``save_load/jobs.py``: ghost loads, ``load_state``, ``strict``,
sharded checkpoints) and the maintenance helpers
(``utils/maintenance.py``), against the JAX package's.

- the registry: built, reused with ``flash``, rebuilt for a job whose
  JSON files are newer than its entry or whose entry has another schema;
  a registry written by either package is read as fresh by the other,
  with equal entries; the O_EXCL lock;
- ghost loads build no module, call no ``resolve_device`` and leave CUDA
  uninitialised;
- a JAX job saved with ``save_job(..., sharded=True)`` (one CPU process)
  loads into the port with the same arrays as its npz twin, and when a
  job holds both formats the newer one wins in both packages;
- ``find_by_job_number`` with ``load_state=False`` (fresh weights),
  ``ghost`` and ``strict=False``; ``needed_remote_files``; soft delete,
  purge, prune and the rsync builders.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from joint_vae_tpu.save_load import fetch as jfetch
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.utils import maintenance as jmaint

from joint_vae_tpu_torch.models.cvnet import CVNet, init_weights
from joint_vae_tpu_torch.save_load import fetch as tfetch
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.from_jax import (opt_state_to_jax,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.utils import maintenance as tmaint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _save(job, d, **kw):
    jjobs.save_job(job, d, **kw)
    return d


@pytest.fixture(scope='module')
def fleet(tmp_path_factory):
    """Four JAX jobs (one with weights, one marked deleted, one derailed,
    one WIM-tuned without its sidecar) under nested set/arch dirs."""
    root = str(tmp_path_factory.mktemp('fleet'))
    cfg = graft._flagship_cfg(tiny=True)
    dirs = []
    for n in range(1, 5):
        job = jjobs.new_job(cfg, key=jax.random.PRNGKey(n) if n == 1 else None,
                            job_number=n)
        job.training_parameters.update({'set': 'cifar10', 'epochs': 3,
                                        'beta': 0.5 * n})
        if n == 4:
            job.training_parameters['wim'] = {'distribution': 'gaussian'}
        job.train_history = {'epochs': n, n: {'test_loss': {'total': 1.0 * n}}}
        job.ood_results = {n: {'svhn': {'iws': {'n': 8, 'auc': 0.1 * n,
                                                'tpr': [0.95],
                                                'fpr': [0.5]}}}}
        dirs.append(_save(job, os.path.join(root, 'cifar10', 'arch{}'.format(
            n % 2), '{:06d}'.format(n))))
    os.makedirs(os.path.join(dirs[0], 'samples', '0001'))
    jjobs.mark(dirs[1], 'deleted')
    jjobs.mark(dirs[2], 'derailed')
    return root, dirs


def _copy(fleet, tmp_path, name='copy'):
    root, dirs = fleet
    dst = str(tmp_path / name)
    shutil.copytree(root, dst)
    return dst, [d.replace(root, dst) for d in dirs]


def test_registry_build_and_flash(fleet, tmp_path, monkeypatch):
    root, dirs = _copy(fleet, tmp_path)
    got = tfetch.fetch_models(root, flash=False)
    want = jfetch.fetch_models(root, flash=False)
    assert json.dumps(got) == json.dumps(want)
    assert sorted(m['job'] for m in got) == [1, 4]   # deleted, derailed gone
    # flash: a fresh registry is served without a single load
    loads = []
    real = tjobs.load_job
    monkeypatch.setattr(tfetch, 'load_job',
                        lambda *a, **k: loads.append(a) or real(*a, **k))
    again = tfetch.fetch_models(root)
    assert loads == []
    assert json.loads(json.dumps(again)) == json.loads(json.dumps(got))
    # a JSON file newer than the entry rebuilds that job alone
    later = time.time() + 5
    os.utime(os.path.join(dirs[3], 'ood.json'), (later, later))
    tfetch.fetch_models(root)
    assert [a[0] for a in loads] == [dirs[3]]
    # an entry of another schema version is rebuilt
    reg = tfetch._registry_path(root)
    cache = json.load(open(reg))
    cache[dirs[0]]['_schema'] = 2
    json.dump(cache, open(reg, 'w'))
    loads.clear()
    tfetch.fetch_models(root)
    assert [a[0] for a in loads] == [dirs[0]]
    # filters apply to the cached entries
    assert [m['job'] for m in tfetch.fetch_models(
        root, filter=lambda m: m['beta'] > 1)] == [4]


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_registry_read_as_fresh_by_the_other(fleet, tmp_path, monkeypatch,
                                             writer):
    root, _ = _copy(fleet, tmp_path)
    first, second = (jfetch, tfetch) if writer == 'jax' else (tfetch, jfetch)
    written = first.fetch_models(root)
    reg = tfetch._registry_path(root)
    assert reg == jfetch._registry_path(root)
    before = open(reg, 'rb').read()
    monkeypatch.setattr(second, 'load_job', lambda *a, **k: pytest.fail(
        'rebuilt a fresh entry'))
    read = second.fetch_models(root)
    assert json.loads(json.dumps(read)) == json.loads(json.dumps(written))
    assert open(reg, 'rb').read() == before


def test_lock(tmp_path):
    path = str(tmp_path / 'reg.json')
    with tfetch._Lock(path) as a:
        assert os.path.exists(path + '.lock')
        assert open(path + '.lock').read() == a._token
        # a second holder waits, then breaks the stale lock and owns it
        b = tfetch._Lock(path, timeout=0.2)
        t0 = time.time()
        with b:
            assert time.time() - t0 >= 0.2
            assert open(path + '.lock').read() == b._token
        assert not os.path.exists(path + '.lock')
    # the first holder's exit leaves a lock it no longer owns alone
    with tfetch._Lock(path):
        with open(path + '.lock', 'w') as f:
            f.write('someone else')
    assert os.path.exists(path + '.lock')
    os.unlink(path + '.lock')
    with jfetch._Lock(path):            # the JAX package's lock agrees
        with pytest.raises(FileExistsError):
            os.open(path + '.lock', os.O_CREAT | os.O_EXCL | os.O_WRONLY)


def test_ghost_loads_touch_no_device(fleet, tmp_path, monkeypatch):
    root, dirs = _copy(fleet, tmp_path)

    def refuse(*a, **k):
        raise AssertionError('a ghost load touched a device or a module')
    monkeypatch.setattr(tjobs, 'resolve_device', refuse)
    monkeypatch.setattr(tjobs, 'CVNet', refuse)
    job = tjobs.load_job(dirs[0], ghost=True)
    assert job.state is None and job.device == torch.device('cpu')
    assert job.ood_results == jjobs.load_job(dirs[0], ghost=True).ood_results
    assert len(tfetch.fetch_models(root, flash=False)) == 2
    code = ('import sys, torch; sys.path.insert(0, {r!r}); '
            'from joint_vae_tpu_torch.save_load import fetch; '
            'n = len(fetch.fetch_models({j!r}, flash=False)); '
            'print(n, torch.cuda.is_initialized())').format(r=ROOT, j=root)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ['2', 'False']


def _port_arrays(job):
    st = job.state
    return (state_dict_to_jax(st.model),
            opt_state_to_jax(st.model, job.opt_cfg, st.opt_state))


def test_sharded_checkpoint_and_newer_of_two(tmp_path):
    cfg = graft._flagship_cfg(tiny=True)
    a = jjobs.new_job(cfg, key=jax.random.PRNGKey(1))
    b = jjobs.new_job(cfg, key=jax.random.PRNGKey(2))
    npz = _save(a, str(tmp_path / 'npz'), sharded=False)
    shards = _save(a, str(tmp_path / 'shards'), sharded=True)
    assert os.path.isfile(os.path.join(shards, 'state.shards',
                                       'manifest.json'))
    assert not os.path.exists(os.path.join(shards, 'state.npz'))
    pa = _port_arrays(tjobs.load_job(npz, device='cpu'))
    pb = _port_arrays(tjobs.load_job(shards, device='cpu'))
    for x, y in zip(pa, pb):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    # the JAX reader stitches the same arrays
    from joint_vae_tpu.save_load.sharded_checkpoint import \
        load_checkpoint_sharded as jload
    from joint_vae_tpu_torch.save_load.sharded_checkpoint import \
        load_checkpoint_sharded as tload
    for stem in ('state', 'optimizer'):
        want = jload(os.path.join(shards, stem + '.shards'))
        got = tload(os.path.join(shards, stem + '.shards'))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # both formats in one job: the newer one wins, in both packages
    both = str(tmp_path / 'both')
    shutil.copytree(npz, both)
    b_dir = _save(b, str(tmp_path / 'b'), sharded=True)
    for stem in ('state', 'optimizer'):
        shutil.copytree(os.path.join(b_dir, stem + '.shards'),
                        os.path.join(both, stem + '.shards'))
    for newer in ('shards', 'npz'):
        t = time.time() + (10 if newer == 'npz' else -10)
        for stem in ('state', 'optimizer'):
            os.utime(os.path.join(both, stem + '.npz'), (t, t))
        got = _port_arrays(tjobs.load_job(both, device='cpu'))[0]
        want_dir = b_dir if newer == 'shards' else npz
        want = _port_arrays(tjobs.load_job(want_dir, device='cpu'))[0]
        jgot = jjobs.load_job(both).state.params
        jwant = jjobs.load_job(want_dir).state.params
        jax.tree_util.tree_map(np.testing.assert_array_equal, jgot, jwant)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_find_by_job_number(fleet, tmp_path):
    root, dirs = _copy(fleet, tmp_path)
    saved = tjobs.load_job(dirs[0], device='cpu')
    fresh = tfetch.find_by_job_number(root, 1, load_state=False,
                                      device='cpu')
    assert fresh.saved_dir == dirs[0] and fresh.job_number == 1
    want = init_weights(CVNet(saved.model_cfg), 0).state_dict()
    got = fresh.model.state_dict()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert any(not torch.equal(saved.model.state_dict()[k], got[k])
               for k in got)
    ghost = tfetch.find_by_job_number(root, 4, ghost=True)
    assert ghost.state is None and ghost.job_number == 4
    assert tfetch.find_by_job_number(root, 99, device='cpu') is None
    # strict=False keeps fresh values for the parameters a state lacks
    z = dict(np.load(os.path.join(dirs[0], 'state.npz')))
    gone = [k for k in z if k.startswith('params/') and 'prior' in k]
    assert gone
    np.savez(os.path.join(dirs[0], 'state.npz'),
             **{k: v for k, v in z.items() if k not in gone})
    with pytest.raises(KeyError):
        tfetch.find_by_job_number(root, 1, device='cpu')
    lenient = tfetch.find_by_job_number(root, 1, device='cpu', strict=False)
    sd, fresh_sd = state_dict_to_jax(lenient.model), state_dict_to_jax(
        init_weights(CVNet(saved.model_cfg), 0))
    for k in gone:
        np.testing.assert_array_equal(sd[k], fresh_sd[k])
    kept = [k for k in z if k.startswith('params/') and k not in gone]
    for k in kept:
        np.testing.assert_array_equal(sd[k], z[k], err_msg=k)


def test_needed_remote_files_and_maintenance(fleet, tmp_path, monkeypatch):
    root, dirs = _copy(fleet, tmp_path)
    assert (tfetch.needed_remote_files(root)
            == jfetch.needed_remote_files(root))
    assert (tfetch.needed_remote_files(root, kinds=('records',))
            == jfetch.needed_remote_files(root, kinds=('records',)))
    assert tmaint.list_deleted(root) == jmaint.list_deleted(root) == [dirs[1]]
    tmaint.delete_job(dirs[3])
    assert tmaint.list_deleted(root) == [dirs[1], dirs[3]]
    assert [m['job'] for m in tfetch.fetch_models(root)] == [1]
    for name in ('a.tmp', 'output.out.old', 'keep.out'):
        open(os.path.join(dirs[0], name), 'w').close()
    assert sorted(tmaint.prune_out_files(root)) == sorted(
        os.path.join(dirs[0], n) for n in ('a.tmp', 'output.out.old'))
    assert os.path.exists(os.path.join(dirs[0], 'keep.out'))
    assert tmaint.purge_deleted(root) == [dirs[1], dirs[3]]
    assert not os.path.exists(dirs[1]) and os.path.exists(dirs[2])
    tmaint.delete_job(dirs[2], purge=True)
    assert not os.path.exists(dirs[2])
    for profile in tmaint.RSYNC_PROFILES:
        for push in (False, True):
            assert (tmaint.rsync_command('host', root, push, profile)
                    == jmaint.rsync_command('host', root, push, profile))
    ran = []
    monkeypatch.setattr(tmaint.subprocess, 'run',
                        lambda cmd, **k: ran.append(cmd))
    tmaint.sync_jobs('host', root, profile='records')
    assert ran == [['rsync', '--dry-run', '-av', '--prune-empty-dirs']
                   + tmaint.RSYNC_PROFILES['records']
                   + ['host:{}/'.format(root), '{}/'.format(root)]]
