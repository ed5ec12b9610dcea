"""The port's train CLI (``python -m joint_vae_tpu_torch.cli.train``) on the
CPU: a tiny cvae job trains, tests and OOD-scores end to end, and the JAX
package's ``load_job`` reads what it wrote; ``--where`` and ``--dry-run``
print the JAX CLI's save dir and write nothing; ``--resume`` continues the
job with its saved data settings; ``--device-data`` trains from the
device-resident set (``train_model(device_data=True)``); ``--mesh`` and
``--distributed`` train on a world of one process, and an axis without
``--mesh`` is refused as the JAX CLI refuses it.
The save dir is the one the JAX CLI's ``save_dir_for`` gives the job.
"""

import os

import numpy as np
import pytest

import joint_vae_tpu.cli.train as jcli
from joint_vae_tpu.save_load import jobs as jjobs

from joint_vae_tpu_torch.cli.train import main
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.recorders import find_record

TINY = ['--dataset', 'mnist', '--type', 'cvae', '--encoder', '8',
        '--decoder', '8', '--classifier', '8', '-K', '4', '--gamma', '10',
        '--batch-size', '32', '--test-batch-size', '64', '--dataset-size',
        '96', '--latent-sampling', '1', '--test-latent-sampling', '2',
        '--oodsets', 'fashion', 'mnist90', '--job-number', '7']


def _run(capsys, *argv):
    capsys.readouterr()
    assert main(list(argv)) == 0
    return capsys.readouterr().out.strip()


def test_train_cli_job_loads_in_jax(tmp_path, capsys):
    jobs = str(tmp_path / 'jobs')
    args = TINY + ['--job-dir', jobs, '--epochs', '1', '--device', 'cpu']
    where = _run(capsys, *args, '--where')
    dry = _run(capsys, *args, '--dry-run')
    assert dry.endswith('-> ' + where) and not os.path.exists(where)

    _run(capsys, *args)
    for f in ('params.json', 'train_params.json', 'state.npz',
              'optimizer.npz', 'test.json', 'ood.json', 'history.json',
              'output.out'):
        assert os.path.exists(os.path.join(where, f)), f
    for s in ('mnist', 'fashion', 'mnist90'):
        assert find_record(os.path.join(where, 'samples', '0001'), s), s
    jjob = jjobs.load_job(where)
    tjob = tjobs.load_job(where, device='cpu')
    assert jcli.save_dir_for(jjob, jobs, 1) == where
    assert jjob.job_number == tjob.job_number == 7 and jjob.trained == 1
    assert set(jjob.ood_results[1]) == {'fashion', 'mnist90'}
    assert jjob.testing[1]['iws']['n'] == 96
    assert np.isfinite(jjob.ood_results[1]['fashion']['iws']['auc'])
    with open(os.path.join(where, 'output.out')) as f:
        assert 'ood:fashi' in f.read()

    # resume: one more epoch, with the job's own data settings
    _run(capsys, '--resume', '7', '--job-dir', jobs, '--epochs', '2',
         '--device', 'cpu', '--dataset-size', '96', '--oodsets', 'fashion')
    back = tjobs.load_job(where, device='cpu')
    assert back.trained == 2 and os.path.exists(os.path.join(where,
                                                             'RESUMED'))
    assert set(back.ood_results) == {1, 2} and 2 in back.testing
    assert _run(capsys, '--resume', '7', '--job-dir', jobs, '--where',
                '--device', 'cpu') == where


@pytest.mark.parametrize('flag,refusal', [
    (['--mesh'], None), (['--distributed'], None),
    (['--sample-axis', '2'], 'need --mesh'),
    (['--model-axis', '2'], 'need --mesh'),
    (['--mesh', '2'], 'needs a world of 2')])
def test_train_cli_refuses_unported_flags(tmp_path, capsys, flag, refusal):
    """The mesh flags run: ``--mesh`` and ``--distributed`` train on a
    world of one process (a mesh of one rank) and the JAX package loads
    the job; the JAX CLI's refusal of an axis without ``--mesh`` stays,
    and a mesh larger than the world is refused."""
    argv = TINY + ['--job-dir', str(tmp_path), '--device', 'cpu',
                   '--epochs', '1'] + flag
    if refusal:
        with pytest.raises(SystemExit, match=refusal):
            main(argv)
        return
    where = _run(capsys, *argv, '--where')
    assert main(argv) == 0
    assert jjobs.load_job(where).trained == 1


def test_train_cli_device_data_trains(tmp_path, capsys, monkeypatch):
    """``--device-data`` reaches ``train_model(device_data=True)``, which
    trains from a DeviceDataset; the job loads in JAX."""
    from joint_vae_tpu_torch.train import trainer
    from joint_vae_tpu_torch.utils.parameters import UNPORTED
    assert 'device_data' not in dict(UNPORTED)
    built = []
    real = trainer.DeviceDataset
    monkeypatch.setattr(trainer, 'DeviceDataset',
                        lambda *a, **k: built.append(a[0].name) or real(*a, **k))
    jobs = str(tmp_path / 'jobs')
    args = TINY + ['--job-dir', jobs, '--epochs', '1', '--device', 'cpu',
                   '--device-data', '--no-final-ood']
    where = _run(capsys, *args, '--where')
    _run(capsys, *args)
    assert built == ['mnist']
    jjob = jjobs.load_job(where)
    assert jjob.trained == 1 and int(jjob.state.step) == 3
    assert np.isfinite(jjob.train_history[1]['train_loss']['total'])
