"""The port's fine-tuning CLI (``python -m joint_vae_tpu_torch.cli.ft``) on
the CPU, from a tiny cvae job that the port's train CLI wrote:

- job mode: a NEW job under ``<job-dir>/wim`` with the next number, the
  source job's files byte-unchanged; ``wim_prior.npz``, the pre-tuning
  ``init/ood.json``, record files carrying ``y_est_already``, and with
  ``--inspection`` the latent dumps, ``inspection.json`` and
  ``proj2d-pca.csv``; the seed defaults to the job number + 7; the JAX
  package's ``load_wim_job`` reads the new job;
- ``--poscod``: the head file written and reloaded, 'llr' results;
- ``--array --register``: the array's rates equal
  ``WIMArray.recompute_rates`` called directly;
- ``--args-from-file`` takes the INDEX-th non-comment line;
- ``--lr`` / ``--weight-decay`` give the fine-tune a fresh adam;
- ``--mesh`` and ``--distributed`` run on a world of one process, and
  an axis without ``--mesh`` is refused as in the JAX CLI.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from joint_vae_tpu.ft import job as jftjob

from joint_vae_tpu_torch.cli.ft import main
from joint_vae_tpu_torch.cli.train import main as train_main
from joint_vae_tpu_torch.ft.array import WIMArray
from joint_vae_tpu_torch.ft.job import load_wim_job
from joint_vae_tpu_torch.ft.poscod import load_poscod_job
from joint_vae_tpu_torch.save_load.checkpoint import load_arrays
from joint_vae_tpu_torch.save_load.recorders import LossRecorder, find_record

FT = ['--device', 'cpu', '--oodsets', 'fashion', '--batch-size', '32',
      '--test-batch-size', '500', '--train-size', '128']


def _digest(d):
    out = {}
    for p, _, fs in os.walk(d):
        for f in fs:
            with open(os.path.join(p, f), 'rb') as fh:
                out[os.path.relpath(os.path.join(p, f), d)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def _wim_dirs(jobs):
    root = os.path.join(jobs, 'wim')
    return sorted(p for p, _, fs in os.walk(root) if 'params.json' in fs)


@pytest.fixture(scope='module')
def cli_jobs(tmp_path_factory):
    """A tiny source job (number 1) and one fine-tune of it with
    ``--inspection`` (number 2), run from a scratch working directory
    (the scheduler writes ``grid/`` there)."""
    root = tmp_path_factory.mktemp('cli_ft')
    jobs = str(root / 'jobs')
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        assert train_main([
            '--device', 'cpu', '--dataset', 'mnist', '--type', 'cvae',
            '--encoder', '8', '--decoder', '8', '--classifier', '8',
            '-K', '4', '--gamma', '10', '--epochs', '1', '--batch-size',
            '32', '--test-batch-size', '64', '--dataset-size', '96',
            '--latent-sampling', '1', '--test-latent-sampling', '2',
            '--oodsets', 'fashion', '--job-dir', jobs]) == 0
        (src,) = [p for p, _, fs in os.walk(jobs) if 'state.npz' in fs]
        before = _digest(src)
        assert main(['1', '--job-dir', jobs, '--inspection'] + FT) == 0
    return {'root': root, 'jobs': jobs, 'src': src, 'before': before}


def test_job_mode_writes_a_new_job(cli_jobs):
    jobs = cli_jobs['jobs']
    assert _digest(cli_jobs['src']) == cli_jobs['before']
    (d,) = _wim_dirs(jobs)
    assert d.endswith('000002')
    for f in ('params.json', 'train_params.json', 'state.npz',
              'optimizer.npz', 'ood.json', 'test.json', 'output.out',
              'wim_prior.npz'):
        assert os.path.exists(os.path.join(d, f)), f
    edir = os.path.join(d, 'samples', '0001')
    with open(os.path.join(edir, 'init', 'ood.json')) as f:
        assert set(json.load(f)) == {'fashion'}
    for s in ('mnist', 'fashion'):
        rec = LossRecorder.load(find_record(edir, s))
        assert 'y_est_already' in rec and 'total@' in rec and 'kl@' in rec
        assert find_record(os.path.join(edir, 'init'), s)
        for sub in ('', 'init'):
            assert os.path.exists(os.path.join(edir, sub,
                                               'sample-{}.npz'.format(s)))
    with open(os.path.join(edir, 'inspection.json')) as f:
        insp = json.load(f)
    assert insp['set'] == 'mnist' and insp['mean_norm'] > 0
    with open(os.path.join(edir, 'proj2d-pca.csv')) as f:
        assert f.readline().strip() == 'x1,x2,y,set,dist,ft'
    with open(os.path.join(d, 'train_params.json')) as f:
        tp = json.load(f)
    assert tp['from_job'] == 1
    assert tp['wim']['seed'] == 8 and tp['wim']['sets'] == ['fashion']
    assert tp['wim']['distribution'] == 'gaussian'
    assert tp['wim']['init_mean'] == 8.0 and tp['wim']['mix'] == 0.5
    (ft,) = tp['fine_tuning']
    assert ft['train_size'] == 128 and ft['moving_size'] == 512
    w = load_wim_job(d, device='cpu')
    assert w.job.job_number == 2
    assert set(w.job.ood_results[1]['fashion']) == {
        'zdist', 'zdist~', 'zdist@', 'zdist~@', 'elbo', 'elbo~', 'elbo@',
        'elbo~@'}
    assert set(w.job.testing[1]['already']) >= {'softzdist~', 'zdist~'}
    jw = jftjob.load_wim_job(d)
    np.testing.assert_array_equal(np.asarray(jw.alternate_prior_params['mean']),
                                  w.alternate_prior_params['mean'].numpy())


def test_poscod_mode(cli_jobs):
    jobs = cli_jobs['jobs']
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cli_jobs['root'])
        assert main(['1', '--job-dir', jobs, '--poscod', '--epochs', '1']
                    + FT) == 0
    assert _digest(cli_jobs['src']) == cli_jobs['before']
    d = [p for p in _wim_dirs(jobs)
         if os.path.exists(os.path.join(p, 'poscod_head.npz'))]
    assert len(d) == 1
    pc = load_poscod_job(d[0], device='cpu')
    assert pc.head['w'].shape == (4,) and float(pc.head['w'].abs().sum()) > 0
    assert pc.job.ood_results[1]['fashion']['llr']['n'] == 10000
    with open(os.path.join(d[0], 'train_params.json')) as f:
        assert json.load(f)['poscod'] == {'epochs': 1}


def test_array_register_matches_recompute_rates(cli_jobs, tmp_path):
    jobs = cli_jobs['jobs']
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cli_jobs['root'])
        assert main(['1', '--job-dir', jobs, '--task', '1']
                    + FT[:-1] + ['64']) == 0
        wims = [d for d in _wim_dirs(jobs)
                if os.path.exists(os.path.join(d, 'wim_prior.npz'))]
        assert len(wims) >= 2
        arr = str(tmp_path / 'arr')
        assert main(['--array', arr, '--register'] + wims[:2]
                    + ['--device', 'cpu', '--oodsets', 'fashion']) == 0
    with open(os.path.join(arr, 'ood.json')) as f:
        got = json.load(f)
    direct = WIMArray(str(tmp_path / 'direct'))
    direct.register_jobs(*wims[:2])
    want = direct.recompute_rates(load_wim_job(wims[0], device='cpu'),
                                  'mnist', ['fashion'])
    assert got == json.loads(json.dumps(want))
    assert got['fashion']['zdist@']['n'] == 20000


def test_args_from_file(cli_jobs, tmp_path):
    jobs = cli_jobs['jobs']
    # a line is the whole argument list, the job number included
    lines = ['# tasks of one array', '1 --task 0 --train-size 96',
             '1 --task 2 --train-size 64 --moving-size 256']
    path = str(tmp_path / 'args')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    seen = set(_wim_dirs(jobs))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cli_jobs['root'])
        assert main(['--job-dir', jobs, '--args-from-file', path, '1',
                     '--device', 'cpu', '--oodsets', 'fashion',
                     '--batch-size', '32', '--test-batch-size', '500',
                     '--lr', '0.01', '--weight-decay', '1e-4']) == 0
    (d,) = set(_wim_dirs(jobs)) - seen
    with open(os.path.join(d, 'train_params.json')) as f:
        (ft,) = json.load(f)['fine_tuning']
    assert ft['train_size'] == 64 and ft['moving_size'] == 256
    opt = load_arrays(os.path.join(d, 'optimizer.npz'))
    (lr,) = [v for k, v in opt.items() if k.endswith('learning_rate')]
    assert lr == np.float32(0.01)
    assert any('/1/mu/' in k for k in opt)        # weight decay in the chain


@pytest.mark.parametrize('flag', [['--mesh'], ['--distributed'],
                                  ['--model-axis', '2']])
def test_mesh_flags_refused(cli_jobs, tmp_path, flag):
    """``--mesh`` and ``--distributed`` fine-tune on a world of one
    process (into a WIM job dir of their own); ``--model-axis`` without
    ``--mesh`` is refused as the JAX CLI refuses it."""
    argv = (['1', '--job-dir', cli_jobs['jobs'], '--wim-job-dir',
             str(tmp_path), '--job-number', '99'] + FT + flag)
    if flag == ['--model-axis', '2']:
        with pytest.raises(SystemExit, match='need --mesh'):
            main(argv)
        return
    assert main(argv) == 0
    (d,) = _wim_dirs_under(str(tmp_path))
    wim = load_wim_job(d, device='cpu')
    assert wim.job.job_number == 99 and wim.job.ood_results


def _wim_dirs_under(root):
    return sorted(p for p, _, fs in os.walk(root) if 'params.json' in fs)
