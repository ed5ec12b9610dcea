"""The port's driver CLIs (sample, aggregate, cascade, grid) and
``results.mutual_info`` against the JAX package's, on two tiny mnist jobs
that the JAX train CLI trained (the port loads them): each package runs
on its own copy of the job store, in-process, with the shape-seeded
latent noise of ``tests/test_torch_engines.py`` on both sides and the
prior draw of ``generation_grid`` injected on both.

- aggregate (``--combos 1 2 --record``): the printed accuracies, ensemble
  and combo rows, mutual-information matrix and OOD AUROCs equal; the
  recorded Im-<T> tensors within 5e-4, the predictions and labels equal;
  ``results.mutual_info`` over both record dirs prints the same tables;
- cascade (``--record --tex``): the printed matrix and stage rows equal,
  ``cascade.json``, the reconstructions and the record within 5e-4, the
  LaTeX table equal;
- sample (``--grids reco gen zsample ood --compare``): the same files,
  every array within 5e-4 (masks and inputs equal), the latent exports
  within 5e-4;
- grid: ``expand_grid``'s argv lists equal, and ``--run`` launches the
  port's train module with ``--device`` forwarded.
"""

import configparser
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from joint_vae_tpu.cli import aggregate as jagg_cli
from joint_vae_tpu.cli import cascade as jcascade_cli
from joint_vae_tpu.cli import grid as jgrid
from joint_vae_tpu.cli import sample as jsample_cli
from joint_vae_tpu.cli.train import main as jtrain
from joint_vae_tpu.evals import sample as jsample
from joint_vae_tpu.results import mutual_info as jmi

from joint_vae_tpu_torch.cli import aggregate as tagg_cli
from joint_vae_tpu_torch.cli import cascade as tcascade_cli
from joint_vae_tpu_torch.cli import grid as tgrid
from joint_vae_tpu_torch.cli import sample as tsample_cli
from joint_vae_tpu_torch.evals import sample as tsample
from joint_vae_tpu_torch.results import mutual_info as tmi
from joint_vae_tpu_torch.save_load.recorders import LossRecorder

from test_torch_engines import numpy_batches, shared_noise  # noqa: F401

TOL = 5e-4
TRAIN_ARGS = ['--dataset', 'mnist', '--type', 'cvae', '--epochs', '1',
              '--batch-size', '32', '--test-batch-size', '64',
              '-K', '8', '--encoder', '32', '--decoder', '32',
              '--classifier', '8', '--gamma', '100', '--sigma', '0.3',
              '--prior-means', '1', '--learned-prior-means',
              '--test-latent-sampling', '2', '--dataset-size', '96',
              '--full-test-every', '100', '--ood-detection-every', '100',
              '--no-final-test', '--no-final-ood', '--platform', 'cpu']


@pytest.fixture(scope='module')
def job_store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('jobs'))
    assert jtrain(TRAIN_ARGS + ['--job-dir', d]) == 0
    assert jtrain(TRAIN_ARGS + ['--job-dir', d, '--seed', '1']) == 0
    return d


@pytest.fixture
def stores(job_store, tmp_path):
    """One copy of the job store per package."""
    out = {}
    for pkg in ('jax', 'torch'):
        out[pkg] = str(tmp_path / pkg)
        shutil.copytree(job_store, out[pkg])
    return out


def _run_both(capsys, stores, jax_main, torch_main, argv, device=True):
    """Both CLIs on their own store (on the CPU); stdout with the store
    path replaced."""
    outs = {}
    for pkg, main, extra in (('jax', jax_main, ['--platform', 'cpu']),
                             ('torch', torch_main, ['--device', 'cpu'])):
        capsys.readouterr()
        args = [a.replace('STORE', stores[pkg]) for a in argv]
        assert main(args + (extra if device else [])) == 0
        outs[pkg] = capsys.readouterr().out.replace(stores[pkg], 'STORE')
    return outs


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind in 'biuUO' or got.dtype.kind in 'biuUO':
        assert np.array_equal(got, want), what
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_records(stores, rel):
    for name in _files(os.path.join(stores['jax'], rel)):
        a = LossRecorder.load(os.path.join(stores['jax'], rel, name))
        b = LossRecorder.load(os.path.join(stores['torch'], rel, name))
        assert set(a.keys()) == set(b.keys()), name
        for k in a.keys():
            _close(b.get(k), a.get(k), '{} {}'.format(name, k))


def test_aggregate_and_mutual_info(capsys, stores, shared_noise):
    out = _run_both(capsys, stores, jagg_cli.main, tagg_cli.main,
                    ['1', '2', '--job-dir', 'STORE', '--combos', '1', '2',
                     '--record', '--batch-size', '32', '-N', '96'])
    assert out['torch'] == out['jax']
    for row in ('job      1: accuracy', 'combo            1|2', 'ood '):
        assert row in out['torch']
    rel = os.path.join('mnist', '1|2')
    assert _files(os.path.join(stores['torch'], rel)) == \
        _files(os.path.join(stores['jax'], rel))
    _same_records(stores, rel)

    mi = _run_both(capsys, stores, jmi.main, tmi.main,
                   [os.path.join('STORE', rel)], device=False)
    assert mi['torch'] == mi['jax'] and 'Im[ok]' in mi['torch']


def test_cascade(capsys, stores, shared_noise):
    out = _run_both(capsys, stores, jcascade_cli.main, tcascade_cli.main,
                    ['1', '2', '--job-dir', 'STORE', '-N', '64', '--record',
                     '--tex', os.path.join('STORE', 'r.tex')])
    assert out['torch'] == out['jax']
    assert 'bayes-iterated accuracy' in out['torch']
    with open(os.path.join(stores['jax'], 'r.tex')) as a, \
            open(os.path.join(stores['torch'], 'r.tex')) as b:
        assert a.read() == b.read()
    _same_records(stores, os.path.join('mnist', '1-2'))
    (casc,) = {os.path.dirname(f) for f in _files(stores['torch'])
               if f.endswith('cascade.json')}
    got, want = (json.load(open(os.path.join(stores[p], casc,
                                             'cascade.json')))
                 for p in ('torch', 'jax'))
    assert got['jobs'] == want['jobs'] and got['n'] == want['n'] == 64
    _close(got['im_t'], want['im_t'], 'im_t')
    for g, w in zip(got['stages'], want['stages']):
        assert set(g) == set(w)
        for k, v in w['mean_losses'].items():
            _close(g['mean_losses'][k], v, k)
        assert g.get('accuracy') == w.get('accuracy')
    with np.load(os.path.join(stores['jax'], casc, 'cascade-recos.npz')) as a, \
            np.load(os.path.join(stores['torch'], casc,
                                 'cascade-recos.npz')) as b:
        for k in a.files:
            _close(b[k], a[k], k)


def _inject_prior_noise(monkeypatch):
    """The same standard normal prior draw for both packages."""
    def noise(shape):
        return np.random.default_rng(sum(shape)).standard_normal(
            shape).astype(np.float32)
    monkeypatch.setattr(jsample, 'jax', types.SimpleNamespace(
        random=types.SimpleNamespace(
            PRNGKey=jax.random.PRNGKey, fold_in=jax.random.fold_in,
            normal=lambda key, shape: jnp.asarray(noise(shape))),
        jit=jax.jit))
    real = tsample.generation_grid

    def generation_grid(job, n_per_class=8, seed=1):
        P = (job.model.prior.mean.shape[0] if job.model_cfg.prior.conditional
             else 1)
        return real(job, n_per_class, seed,
                    eps=noise((P, n_per_class, job.model_cfg.latent_dim)))
    monkeypatch.setattr(tsample_cli, 'generation_grid', generation_grid)


def test_sample(capsys, stores, shared_noise, monkeypatch):
    _inject_prior_noise(monkeypatch)
    out = _run_both(capsys, stores, jsample_cli.main, tsample_cli.main,
                    ['1', '--job-dir', 'STORE', '--grids', 'reco', 'gen',
                     'zsample', 'ood', '-N', '4', '-L', '2', '--compare',
                     '2', '--batch-size', '32'])
    assert out['torch'] == out['jax']
    files = _files(stores['torch'])
    assert files == _files(stores['jax'])
    grids = [f for f in files if '/samples/grids/' in f]
    for name in ('reco-mnist.npz', 'reco-correct.npz', 'generation.npz',
                 'comparison.npz', 'comparison.json', 'hist-of-var.dat'):
        assert any(f.endswith('/' + name) for f in grids), name
    for f in grids:
        a, b = (os.path.join(stores[p], f) for p in ('jax', 'torch'))
        if f.endswith('.npz'):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files, f
                for k in za.files:
                    _close(zb[k], za[k], '{} {}'.format(f, k))
        elif f.endswith('.json'):
            ja, jb = json.load(open(a)), json.load(open(b))
            assert ja['jobs'] == jb['jobs']
            _close(jb['mse'], ja['mse'], f)
        elif f.endswith('.dat'):
            _close(np.loadtxt(b, ndmin=2), np.loadtxt(a, ndmin=2), f)


GRIDS = """
[sweep]
dataset = mnist
latent-dim = 4 8
beta = 1e-4 1e-3
batch_norm = false
device-data = true

[zipped]
beta = 1e-4|1e-3
lr = 1e-3|1e-4
repeat = 2
"""


@pytest.mark.parametrize('section', ['sweep', 'zipped'])
def test_expand_grid_matches_jax(section):
    cp = configparser.ConfigParser()
    cp.read_string(GRIDS)
    want = jgrid.expand_grid(dict(cp[section]))
    assert tgrid.expand_grid(dict(cp[section])) == want
    assert len(want) == {'sweep': 4, 'zipped': 4}[section]


def test_grid_run_launches_the_port(tmp_path, capsys, monkeypatch):
    ini = tmp_path / 'grids.ini'
    ini.write_text(GRIDS)
    ran = []
    monkeypatch.setattr(tgrid.subprocess, 'run',
                        lambda c: ran.append(c) or types.SimpleNamespace(
                            returncode=0))
    assert tgrid.main([str(ini), 'sweep', '--run', '--device', 'cpu',
                       '--extra=--epochs=1']) == 0
    cp = configparser.ConfigParser()
    cp.read_string(GRIDS)
    want = jgrid.expand_grid(dict(cp['sweep']))
    assert [c[1:3] for c in ran] == [['-m', 'joint_vae_tpu_torch.cli.train']] * 4
    assert [c[3:] for c in ran] == [w + ['--epochs=1', '--device', 'cpu']
                                    for w in want]
    printed = capsys.readouterr().out.splitlines()
    assert printed == [' '.join(c) for c in ran]
