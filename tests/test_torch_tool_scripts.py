"""The port's maintenance and profiling scripts without JAX, on the CPU:

- ``scripts/torch_delete_jobs.py`` and ``scripts/torch_rsync_jobs.py``
  against the JAX package's ``scripts/delete-jobs.py`` and
  ``scripts/rsync-jobs.py`` on two copies of one fleet of port jobs: the
  same output, exit code and tree after a soft delete, after a purge and
  for a missing job; the same rsync command line in a dry run and with
  ``--go`` (an ``rsync`` stand-in on ``PATH`` echoes its arguments, so no
  host is contacted);
- ``scripts/torch_profile_step.py``: a rehearsal of the train step and of
  the Scorer batch on the tiny flagship, eager and graphed (on the CPU
  the graph's body runs eagerly; no device time is recorded), of
  another checkout's port named on ``PYTHONPATH``; its imagenet64
  geometry's program (one full-width train step, in process);
- ``scripts/torch_eval_times.py``: without a card it stops before it
  writes anything.
"""

import json
import os
import shutil
import stat
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def fleet(tmp_path_factory):
    """Three port jobs (numbers 1-3) under nested set/arch directories."""
    from joint_vae_tpu_torch.models.cvnet import flagship_config
    from joint_vae_tpu_torch.save_load.jobs import new_job, save_job
    root = str(tmp_path_factory.mktemp('fleet'))
    for n in (1, 2, 3):
        job = new_job(flagship_config(tiny=True), seed=n, device='cpu',
                      job_number=n)
        save_job(job, os.path.join(root, 'cifar10', 'arch{}'.format(n % 2),
                                   '{:06d}'.format(n)))
    return root


def _tree(root: str) -> list:
    out = []
    for d, dirs, files in os.walk(root):
        dirs.sort()
        out += sorted(os.path.relpath(os.path.join(d, f), root)
                      for f in files)
    return out


def _run(script: str, args, cwd: str, env=None):
    r = subprocess.run([sys.executable, os.path.join(ROOT, 'scripts', script)]
                       + list(args), cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=240)
    return r.returncode, r.stdout, r.stderr


@pytest.mark.parametrize('args', [['2'], ['1', '3', '--purge'], ['2', '7']],
                         ids=['soft', 'purge', 'missing'])
def test_delete_jobs_matches_the_jax_script(fleet, tmp_path, args):
    out = {}
    for script in ('delete-jobs.py', 'torch_delete_jobs.py'):
        root = str(tmp_path / script)
        shutil.copytree(fleet, root)
        # the JAX script imports its package from the working directory
        rc, stdout, stderr = _run(script, args + ['--job-dir', root], ROOT)
        out[script] = (rc, stdout.replace(root, '<root>'),
                       stderr.strip().splitlines()[-1:] if rc else [],
                       _tree(root))
    assert out['delete-jobs.py'] == out['torch_delete_jobs.py']
    rc, stdout, _, tree = out['torch_delete_jobs.py']
    assert rc == (1 if '7' in args else 0) and stdout


@pytest.mark.parametrize('args', [[], ['--push', '--profile', 'records'],
                                  ['--profile', 'full', '--go']],
                         ids=['pull', 'push_records', 'full_go'])
def test_rsync_jobs_matches_the_jax_script(tmp_path, args):
    bindir = tmp_path / 'bin'
    bindir.mkdir()
    fake = bindir / 'rsync'
    fake.write_text('#!/bin/sh\necho "rsync-args: $*"\necho "to stderr" >&2\n'
                    'exit 3\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH='{}:{}'.format(bindir, os.environ['PATH']))
    out = {script: _run(script, ['host'] + args + ['--job-dir', 'jobs'],
                        ROOT, env)
           for script in ('rsync-jobs.py', 'torch_rsync_jobs.py')}
    assert out['rsync-jobs.py'] == out['torch_rsync_jobs.py']
    rc, stdout, stderr = out['torch_rsync_jobs.py']
    lines = stdout.splitlines()
    assert rc == 3 and stderr == 'to stderr\n'
    assert lines[0].startswith('rsync -av --prune-empty-dirs')
    assert ('--dry-run' in lines[1]) == ('--go' not in args)


@pytest.mark.parametrize('mode', ['train', 'eval'])
def test_profile_step_rehearses_on_the_cpu(tmp_path, mode):
    out = str(tmp_path / 'profile.json')
    args = ['--device', 'cpu', '--tiny', '--steps', '2', '--batch', '8',
            '--dtype', 'float32', '--out', out]
    if mode == 'eval':
        args.append('--eval')
    rc, stdout, stderr = _run('torch_profile_step.py', args, str(tmp_path))
    assert rc == 0, stderr[-2000:]
    with open(out) as f:
        rec = json.load(f)
    assert json.loads(stdout.strip().splitlines()[-1]) == rec
    assert rec['program'] == ('scorer_batch' if mode == 'eval'
                              else 'train_step')
    assert set(rec['modes']) == {'eager', 'graph'}
    for m in rec['modes'].values():
        assert m['ms_per_step'] > 0 and m['captures'] == []
        assert set(m) >= {'wall_ms', 'device_ms', 'by_name_ms', 'by_span_ms',
                          'kernels', 'span_assignment', 'images_per_s'}


def test_profile_step_runs_the_port_on_pythonpath(tmp_path):
    """A ``joint_vae_tpu_torch`` on ``PYTHONPATH`` (another checkout's) is
    the one the profiler runs, and its line names that checkout."""
    other = tmp_path / 'other'
    shutil.copytree(os.path.join(ROOT, 'joint_vae_tpu_torch'),
                    str(other / 'joint_vae_tpu_torch'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    env = dict(os.environ, PYTHONPATH=str(other))
    rc, stdout, stderr = _run('torch_profile_step.py', [
        '--device', 'cpu', '--tiny', '--steps', '1', '--batch', '4',
        '--dtype', 'float32', '--eager'], str(tmp_path), env)
    assert rc == 0, stderr[-2000:]
    rec = json.loads(stdout.strip().splitlines()[-1])
    assert rec['root'] == str(other) and set(rec['modes']) == {'eager'}


def test_profile_step_takes_the_imagenet64_geometry(tmp_path, monkeypatch):
    """``--geometry imagenet64``'s program is the full-width imagenet64
    train step (one step at batch 1 on the CPU, in process: profiling it
    under the suite's workers would take minutes); ``--tiny`` is the
    flagship's alone."""
    import argparse
    import importlib.util
    import torch
    import joint_vae_tpu_torch.save_load.jobs as jobs
    spec = importlib.util.spec_from_file_location(
        'torch_profile_step', os.path.join(ROOT, 'scripts',
                                           'torch_profile_step.py'))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    made = []
    real = jobs.new_job
    monkeypatch.setattr(jobs, 'new_job',
                        lambda *a, **k: made.append(real(*a, **k)) or made[-1])
    args = argparse.Namespace(geometry='imagenet64', tiny=False, batch=1,
                              dtype='float32', eval=False)
    run, graph = script._program(args, False, torch.device('cpu'))
    run()
    (job,) = made
    assert job.model_cfg.features == 'vgg16' and job.model_cfg.num_labels == 1000
    assert sum(p.numel() for p in job.model.parameters()) == 40566355
    assert graph.captures == []
    rc, _, stderr = _run('torch_profile_step.py', [
        '--device', 'cpu', '--geometry', 'imagenet64', '--tiny'],
        str(tmp_path))
    assert rc == 2 and '--tiny is the tiny flagship' in stderr


def test_eval_times_needs_a_card(tmp_path):
    rc, stdout, stderr = _run('torch_eval_times.py', ['--repeats', '1'],
                              str(tmp_path))
    assert rc != 0 and 'no CUDA card' in stderr and not stdout
    assert not os.path.exists(tmp_path / 'jobs')
