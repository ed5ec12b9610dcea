"""The port's import CLI (``python -m joint_vae_tpu_torch.cli.import_ref``)
against the JAX package's on the same reference-layout trees, on the CPU:

- ``--scan`` keeps the <dataset>/<arch>/<options>/<job#> layout; a
  corrupt job is logged and counted (``2 imported, 1 failed``, exit 1)
  while the others import, and the two CLIs write the same files (JSON
  byte-equal, arrays bit-equal but for the JAX package's ``rng``);
- ``--dry-run`` prints the same plan and writes nothing;
- ``--job-number`` with two sources is refused (exit 2), with one it
  renumbers the job;
- ``--no-recorders`` skips the record files;
- two explicit sources with one basename land apart (``7``, ``7-1``);
- without ``--device`` the template goes to the card, so a host without
  one fails every job with the reason and exits 1.
"""

import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from joint_vae_tpu.cli.import_ref import main as jmain

from joint_vae_tpu_torch.cli.import_ref import main
from joint_vae_tpu_torch.save_load.from_jax import (opt_state_to_jax,
                                                    state_dict_to_jax)
from joint_vae_tpu_torch.save_load.jobs import load_job, new_job
from joint_vae_tpu_torch.save_load.recorders import LossRecorder
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig

from torch_port_util import port_cfg
from torch_reference_layout import loss_record_dump, write_reference_job


def _write(job_dir, seed=1, job_number=None):
    cfg = port_cfg(graft._flagship_cfg(tiny=True))
    job = new_job(cfg, OptimizerConfig(lr=1e-4), seed=seed, device='cpu')
    arch = dict(cfg.architecture)
    if job_number is not None:
        arch['job_number'] = job_number
    rec = LossRecorder(batch_size=4)
    rec.append_batch(total=np.arange(8, dtype=np.float32).reshape(2, 4))
    write_reference_job(
        str(job_dir), arch, state_dict_to_jax(job.model),
        training_parameters=dict(job.training_parameters),
        history={'epochs': 1},
        opt_arrays=opt_state_to_jax(job.model, job.opt_cfg,
                                    job.state.opt_state),
        records={'1': {'record-cifar10.pth': loss_record_dump(rec)}})


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('refroot')
    _write(root / 'cifar100' / 'archX' / 'opt' / '12', seed=1)
    _write(root / 'cifar100' / 'archY' / 'opt' / '3', seed=2, job_number=4)
    bad = root / 'cifar100' / 'archX' / 'opt' / '2'
    bad.mkdir(parents=True)
    (bad / 'params.json').write_text('{ this is not json')
    return root


def _files(root):
    out = set()
    for d, _, fs in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, f), root) for f in fs}
    return out


def test_scan_layout_and_corrupt_job(tree, tmp_path, capsys):
    jobs = tmp_path / 'jobs'
    rc = main(['--scan', str(tree), '-J', str(jobs), '--device', 'cpu'])
    out = capsys.readouterr().out
    assert rc == 1
    assert '2 imported, 1 failed' in out
    rc_jax = jmain(['--scan', str(tree), '-J', str(tmp_path / 'jax'),
                    '--platform', 'cpu'])
    assert rc_jax == 1
    assert '2 imported, 1 failed' in capsys.readouterr().out
    files = _files(jobs)
    assert files == _files(tmp_path / 'jax')
    for rel in ('cifar100/archX/opt/12', 'cifar100/archY/opt/3'):
        for f in ('params.json', 'train_params.json', 'history.json',
                  'state.npz', 'optimizer.npz', 'samples/0001/record-cifar10.jvr'):
            assert os.path.join(rel, f) in files
    assert not any(f.startswith('cifar100/archX/opt/2') for f in files)
    for rel in sorted(files):
        a, b = jobs / rel, tmp_path / 'jax' / rel
        if rel.endswith('.npz'):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(set(zb.files) - {'rng'}), rel
            for k in za.files:
                assert za[k].tobytes() == zb[k].tobytes(), (rel, k)
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    assert load_job(str(jobs / 'cifar100/archX/opt/12'),
                    device='cpu').job_number == 12
    # the job number of params.json wins over the directory's name
    assert json.loads((jobs / 'cifar100/archY/opt/3/params.json')
                      .read_text())['job_number'] == 4


def test_dry_run_prints_the_plan(tree, tmp_path, capsys):
    jobs = str(tmp_path / 'jobs')
    assert main(['--scan', str(tree), '-J', jobs, '--dry-run']) == 0
    out = capsys.readouterr().out
    assert jmain(['--scan', str(tree), '-J', jobs, '--dry-run',
                  '--platform', 'cpu']) == 0
    assert capsys.readouterr().out == out
    assert len(out.splitlines()) == 3 and 'imported' not in out
    assert not os.path.exists(jobs)


def test_job_number(tree, tmp_path, capsys):
    srcs = [str(tree / 'cifar100/archX/opt/12'),
            str(tree / 'cifar100/archY/opt/3')]
    for fn, extra in ((main, ['--device', 'cpu']),
                      (jmain, ['--platform', 'cpu'])):
        with pytest.raises(SystemExit) as e:
            fn(srcs + ['-J', str(tmp_path / 'x'), '--job-number', '5']
               + extra)
        assert e.value.code == 2
        assert '--job-number only applies to a single source' in \
            capsys.readouterr().err
    assert main(srcs[:1] + ['-J', str(tmp_path / 'one'), '--job-number',
                            '5', '--device', 'cpu']) == 0
    assert load_job(str(tmp_path / 'one' / '12'),
                    ghost=True).job_number == 5


def test_no_recorders_and_basename_collisions(tmp_path, capsys):
    a, b = tmp_path / 'a' / '7', tmp_path / 'b' / '7'
    _write(a, seed=1)
    _write(b, seed=2)
    jobs = tmp_path / 'jobs'
    assert main([str(a), str(b), '-J', str(jobs), '--no-recorders',
                 '--device', 'cpu']) == 0
    assert '2 imported, 0 failed' in capsys.readouterr().out
    assert sorted(os.listdir(jobs)) == ['7', '7-1']
    for d in ('7', '7-1'):
        assert not os.path.exists(jobs / d / 'samples')
        assert os.path.exists(jobs / d / 'state.npz')
    w7 = np.load(jobs / '7' / 'state.npz')
    w71 = np.load(jobs / '7-1' / 'state.npz')
    k = 'params/encoder/dense_mean/kernel'
    assert not np.array_equal(w7[k], w71[k])     # the second did not overwrite


def test_card_by_default(tree, tmp_path, capsys, monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = main([str(tree / 'cifar100/archX/opt/12'), '-J',
               str(tmp_path / 'jobs')])
    assert rc == 1
    assert '0 imported, 1 failed' in capsys.readouterr().out
    assert 'no CUDA device is available' in caplog.text
    assert not os.path.exists(tmp_path / 'jobs' / '12' / 'state.npz')


def test_no_sources_refused(capsys):
    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code == 2
    assert 'no sources' in capsys.readouterr().err
