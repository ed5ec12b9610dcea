"""The port's fleet-evaluation CLIs (``cli/test.py``, ``cli/results.py``)
against the JAX package's, in-process, each on its own copy of one fleet.

The fleet: a tiny mnist-shaped cvae (weights from a numpy-seeded JAX
init) whose results and record files the JAX test CLI computes once
(``--compute hard``, 64 test samples, mnist against fashion), copied
into five jobs with other job numbers, ``beta`` and ``sigma``, one with
a validation history.

- no ``--compute`` and ``--dry-run`` (nothing recomputed): the
  ``.tab``/``.tex`` files (the table, its aggregate) and every job's
  ``test.json``/``ood.json`` byte-equal;
- ``--compute`` (json + recorders) and ``re`` (recorders alone), which
  re-score from the record files: the tables byte-equal; the saved
  results equal, except two float32 reductions whose last bit depends on
  the summation order: a misclassification AUC (a trapezoid sum) within
  one float32 ulp, and the thresholds of the around-mean ('-2s') geometry,
  whose center is a float32 mean, within 4 ulps, their rates within one
  sample (``tests/test_torch_engines.py`` holds them so);
- ``rehard`` (a recompute): both packages draw the latent noise from
  ``tests/test_torch_engines.py``'s ``shared_noise``; the saved results
  agree within that file's 5e-4;
- ``--list-jobs-and-quit``, ``--last``, ``--sort``, ``--from-files``,
  ``--early-stopping``, ``--all-epochs``, ``--export-losses`` and the
  column options: the same files; the mesh flags run on a world of one;
- ``cli.results`` in comparison and per-section modes: the same files.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest

from joint_vae_tpu.cli import results as jresults
from joint_vae_tpu.cli import test as jtest
from joint_vae_tpu.models.cvnet import CVNetConfig as JConfig
from joint_vae_tpu.ops.priors import PriorConfig
from joint_vae_tpu.ops.sigma import SigmaConfig
from joint_vae_tpu.save_load import jobs as jjobs

from joint_vae_tpu_torch.cli import results as tresults
from joint_vae_tpu_torch.cli import test as ttest

from test_torch_engines import (COMPUTE_TOL, _close_tree,  # noqa: F401
                                numpy_batches, shared_noise)

SETS = ['--sets', 'mnist', 'fashion']
SAMPLE = ['-t', '64', '-M', '32']
EPOCH = 2


def _config():
    return JConfig(input_shape=(1, 28, 28), num_labels=10, type='cvae',
                   encoder=(16,), decoder=(16,), classifier=(8,),
                   latent_dim=4, latent_sampling=1, test_latent_sampling=2,
                   gamma=10.0, sigma=SigmaConfig(value=0.5),
                   prior=PriorConfig(dim=4, init_mean=1.0))


@pytest.fixture(scope='module')
def fleet(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('cli_fleet'))
    seed_dir = os.path.join(root, 'seed', 'job')
    job = jjobs.new_job(_config(), key=jax.random.PRNGKey(0), job_number=1)
    job.training_parameters.update({'set': 'mnist', 'epochs': EPOCH,
                                    'batch_size': 32})
    job.train_history = {'epochs': EPOCH,
                         1: {'test_loss': {'total': 3.0}},
                         2: {'test_loss': {'total': 2.5}}}
    jjobs.save_job(job, seed_dir)
    with contextlib.redirect_stdout(io.StringIO()):
        assert jtest.main(['--job-dir', os.path.dirname(seed_dir),
                           '--compute', 'hard', '--platform', 'cpu']
                          + SAMPLE + SETS) == 0
    base = os.path.join(root, 'base')
    for n, (beta, sigma) in enumerate([(1.0, 0.5), (1.0, 0.25), (2.0, 0.5),
                                       (2.0, 0.25), (1.0, 0.5)], 1):
        d = os.path.join(base, 'mnist', 'b{}'.format(beta), '{:06d}'.format(n))
        shutil.copytree(seed_dir, d)
        for name, edit in (('params.json', {'job_number': n}),
                           ('train_params.json', {'beta': beta})):
            p = os.path.join(d, name)
            js = json.load(open(p))
            js.update(edit)
            if name == 'train_params.json':
                js['sigma'].update(value=sigma, sigma0=sigma)
            json.dump(js, open(p, 'w'), indent=1)
        if n == 3:
            p = os.path.join(d, 'history.json')
            h = json.load(open(p))
            h['1']['validation_loss'] = {'total': 1.0}
            h['2']['validation_loss'] = {'total': 2.0}
            json.dump(h, open(p, 'w'), indent=1)
    return base


def _run_both(fleet, tmp_path, args):
    """Run both CLIs on copies of the fleet; returns {pkg: (root, stdout)}."""
    out = {}
    for pkg, main, extra in (('jax', jtest.main, ['--platform', 'cpu']),
                             ('torch', ttest.main, ['--device', 'cpu'])):
        root = str(tmp_path / pkg)
        shutil.copytree(fleet, root)
        res = ['--results-directory', os.path.join(root, 'res')]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(['--job-dir', root] + res + args + extra)
        assert rc == 0
        out[pkg] = (root, buf.getvalue())
    return out


def _files(root):
    got = {}
    for dp, _, fns in os.walk(root):
        for f in fns:
            if f.endswith(('.json', '.tab', '.tex')) and not f.startswith(
                    'models-'):
                p = os.path.join(dp, f)
                got[os.path.relpath(p, root)] = open(p, 'rb').read()
    return got


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


def _same_results(got, want, name, path=()):
    """Equal, but for the two float32 reductions (module docstring)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same_results(got[k], want[k], name, path + (k,))
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for g, w in zip(got, want):
            _same_results(g, w, name, path)
    elif got != want:
        field = path[-1]
        around = [p for p in path if str(p).endswith('-2s')]
        if field == 'auc' and name == 'test.json':
            assert _ulps(got, want) <= 1, path
        elif around and field in ('thresholds', 'thresholds_up'):
            assert _ulps(got, want) <= 4, path
        elif around and field in ('fpr', 'precision', 'auc'):
            assert abs(got - want) <= 1 / 64, path
        else:
            raise AssertionError('{}: {} != {}'.format(path, got, want))


def _assert_same_files(out, rescored=False):
    a, b = _files(out['jax'][0]), _files(out['torch'][0])
    assert sorted(a) == sorted(b)
    bad = [k for k in a if a[k] != b[k]]
    if rescored:
        for k in bad:
            assert k.endswith(('test.json', 'ood.json')), k
            _same_results(json.loads(b[k]), json.loads(a[k]),
                          os.path.basename(k))
    else:
        assert not bad, bad
    assert any(k.endswith('.tex') for k in a)
    return a


TABLES = ['--results-file', 'tab', '--latex', '--agg']


@pytest.mark.parametrize('tier', [[], ['--compute'], ['--compute', 're'],
                                  ['--compute', 'rehard', '--dry-run'],
                                  ['--compute', 'hard', '--dry-run']],
                         ids=['json', 'recorder', 're', 'dry-run-rehard',
                              'dry-run-hard'])
def test_tiers(fleet, tmp_path, tier):
    rescored = tier in (['--compute'], ['--compute', 're'])
    out = _run_both(fleet, tmp_path, tier + TABLES + SAMPLE + SETS)
    files = _assert_same_files(out, rescored)
    assert 'res/tab-agg.tab' in files


def test_rehard_with_shared_noise(fleet, tmp_path, shared_noise):
    out = _run_both(fleet, tmp_path, ['--compute', 'rehard', '--job', '1']
                    + TABLES + SAMPLE + SETS)
    for name in ('test.json', 'ood.json'):
        got, want = (json.load(open(os.path.join(
            out[pkg][0], 'mnist', 'b1.0', '000001', name)))
            for pkg in ('torch', 'jax'))
        assert got.keys() == want.keys()
        _close_tree(got[str(EPOCH)], want[str(EPOCH)], COMPUTE_TOL, name,
                    one_sample=1 / 32)


FLAG_CASES = {
    'last-sort': ['--last', '3', '--sort', 'beta-', 'job'],
    'sort-print': ['--sort', 'print', 'sigma'],
    'early-stopping': ['--early-stopping', '--compute'],
    'all-epochs': ['--all-epochs', '-x', '-x'],
    'columns': ['-e', '-e', '-e', '-e', '--best', '--tnr', '--tpr', '90'],
    'remove-index': ['--remove-index', 'beta', 'set', 'nothing',
                     '--only-average'],
    'filters': ['--beta', '1', '-s', 'not', '0.25', '--job', '1...3'],
    'epoch': ['--epoch', '2', '--epoch-tolerance', '0', '-F'],
}


@pytest.mark.parametrize('flags', list(FLAG_CASES.values()),
                         ids=list(FLAG_CASES))
def test_flags_byte_equal(fleet, tmp_path, flags):
    _assert_same_files(_run_both(fleet, tmp_path, flags + TABLES + SETS),
                       rescored='--compute' in flags)


def test_from_files(fleet, tmp_path):
    ini = str(tmp_path / 'filters.ini')
    with open(ini, 'w') as f:
        f.write('[low]\nbeta = 1\nsigma = 0.5\n[high]\nbeta = 2\n'
                '[options]\nmnist ood = fashion\nood_methods = iws elbo\n')
    _assert_same_files(_run_both(fleet, tmp_path, ['--from-files', ini,
                                                   '-x', '-x'] + TABLES))


def test_list_jobs_and_export_losses(fleet, tmp_path):
    out = _run_both(fleet, tmp_path, ['--list-jobs-and-quit'])
    lists = {pkg: [line.split()[0] for line in o.splitlines()]
             for pkg, (_, o) in out.items()}
    assert lists['torch'] == lists['jax'] == ['1', '2', '3', '4', '5']
    out = _run_both(fleet, tmp_path / 'export',
                    ['--export-losses', '--job', '2', '4'] + SETS)
    a = {k: v for k, v in _files(out['jax'][0]).items() if 'losses-' in k}
    b = {k: v for k, v in _files(out['torch'][0]).items() if 'losses-' in k}
    assert sorted(a) == sorted(b) and len(a) == 4
    assert all(a[k] == b[k] for k in a)


@pytest.mark.parametrize('flag', [['--mesh'], ['--model-axis', '2'],
                                  ['--sample-axis', '2'], ['--distributed']],
                         ids=lambda f: f[0])
def test_mesh_flags_refused(fleet, capsys, flag):
    """``--mesh`` and ``--distributed`` run on a world of one process and
    print the fleet's table as without them; an axis without ``--mesh``
    is refused as the JAX CLI refuses it."""
    argv = ['--job-dir', fleet, '--device', 'cpu']
    if flag[0] in ('--model-axis', '--sample-axis'):
        with pytest.raises(SystemExit, match='need --mesh'):
            ttest.main(argv + flag)
        return
    capsys.readouterr()
    assert ttest.main(argv) == 0
    plain = capsys.readouterr().out
    assert ttest.main(argv + flag) == 0
    assert capsys.readouterr().out == plain and plain


RESULTS_INIS = {
    'comparison': ('[DEFAULT]\ndataset = mnist\nood = fashion\ntpr = 95\n'
                   'average = average fashion\nkept_index = sigma\n\n'
                   '[low]\nbeta = 1\n\n[high]\nbeta = 2\nepoch = 2\n'),
    'section': ('[all-cvae]\ntype = cvae\nagg = true\nbest = true\n\n'
                '[low]\nbeta = 1\ntpr = 90\nepoch = min-loss\n\n'
                '[none]\nbeta = 7\n'),
}


@pytest.mark.parametrize('mode', list(RESULTS_INIS))
def test_results_cli_byte_equal(fleet, tmp_path, mode):
    outs = {}
    for pkg, main, extra in (('jax', jresults.main, ['--platform', 'cpu']),
                             ('torch', tresults.main, [])):
        d = tmp_path / pkg
        d.mkdir()
        ini = str(d / 'tabs.ini')
        with open(ini, 'w') as f:
            f.write(RESULTS_INIS[mode])
        with contextlib.redirect_stdout(io.StringIO()):
            main([ini, '--job-dir', fleet, '--out-dir', str(d / 'out'),
                  '--register'] + extra)
        outs[pkg] = _files(str(d / 'out'))
    assert outs['torch'] == outs['jax']
    assert len(outs['jax']) == (2 if mode == 'comparison' else 4)
