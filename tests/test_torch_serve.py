"""The port's serving path against the JAX package: ``Scorer`` with explicit
and calibrated thresholds, ``predict``, job directories written by one
package and read by the other, the serve CLI's JSON lines, and the rule
that entry points never fall back to the CPU unasked."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.models.cvnet import CVNetConfig as JCVNetConfig
from joint_vae_tpu.ops.sigma import SigmaConfig as JSigmaConfig
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu import serve as jserve

from joint_vae_tpu_torch import serve as tserve
from joint_vae_tpu_torch.models.cvnet import flagship_config
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.from_jax import state_dict_to_jax
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
from joint_vae_tpu_torch.train.state import create_train_state

from torch_port_util import (close, inject_jax_eps, jax_arrays, make_eps,
                             port_model, port_sigma_state)

METHODS = ('iws', 'elbo', 'zdist', 'mse', 'soft', 'iws-2s', 'elbo-2s')
N = 6


def _gap_thresholds(scores):
    """Thresholds half-way between two neighbouring scores, so the accept
    bit is far from any rounding difference."""
    out = {}
    for m, s in scores.items():
        s = np.sort(np.asarray(s))
        mid = lambda i: float(0.5 * (s[i] + s[i + 1]))
        out[m] = (mid(0), mid(len(s) - 2)) if m.endswith('-2s') else mid(1)
    return out


@pytest.fixture(scope='module')
def jax_job():
    job = jjobs.new_job(graft._flagship_cfg(tiny=True),
                        key=jax.random.PRNGKey(0))
    job.train_history = {'epochs': 1}
    return job


@pytest.fixture
def x():
    return np.random.default_rng(11).uniform(0, 1, (N, 3, 8, 8)).astype(np.float32)


def _port_job(jax_job):
    model = port_model(jax_job.model_cfg, jax_job.state)
    state = create_train_state(model, OptimizerConfig(),
                               sigma_state=port_sigma_state(jax_job.state))
    return tjobs.Job(model_cfg=model.cfg, state=state)


def _compare(got, want):
    np.testing.assert_array_equal(got['label'], np.asarray(want['label']))
    np.testing.assert_array_equal(got['in_distribution'],
                                  np.asarray(want['in_distribution']))
    close(got['confidence'], np.asarray(want['confidence']), 5e-4)
    for m in METHODS:
        close(got['scores'][m], np.asarray(want['scores'][m]), 5e-4, m)


def test_scorer_matches_jax(jax_job, x, monkeypatch):
    eps = make_eps((3, N, 16))
    inject_jax_eps(monkeypatch, eps)
    free = {m: float('-inf') for m in METHODS}
    probe = jserve.Scorer(jax_job, methods=METHODS, thresholds=free)(x)
    thr = _gap_thresholds(probe['scores'])
    want = jserve.Scorer(jax_job, methods=METHODS, thresholds=thr)(x)
    assert 0 < np.asarray(want['in_distribution']).sum() < N
    job = _port_job(jax_job)
    got = tserve.Scorer(job, methods=METHODS, thresholds=thr)(
        x, eps=torch.from_numpy(eps))
    _compare(got, want)


def test_predict_matches_jax(jax_job, x, monkeypatch):
    eps = make_eps((3, N, 16), seed=3)
    inject_jax_eps(monkeypatch, eps)
    job = _port_job(jax_job)
    for method in ('iws', 'closest', 'esty'):
        want = jserve.predict(jax_job, x, method)
        got = tserve.predict(job, x, method, eps=torch.from_numpy(eps))
        np.testing.assert_array_equal(got, np.asarray(want))


def _ood_entry(thr):
    return {1: {'noise': {m: {'tpr': [0.9, 0.95], 'thresholds': [-1e9, v]}
                          for m, v in thr.items() if not m.endswith('-2s')}}}


def test_jax_saved_job_loads_in_port(jax_job, x, monkeypatch, tmp_path):
    eps = make_eps((3, N, 16), seed=5)
    inject_jax_eps(monkeypatch, eps)
    free = {m: float('-inf') for m in METHODS}
    probe = jserve.Scorer(jax_job, methods=METHODS, thresholds=free)(x)
    jax_job.ood_results = _ood_entry(_gap_thresholds(probe['scores']))
    d = str(tmp_path / 'jaxjob')
    jjobs.save_job(jax_job, d)
    jloaded = jjobs.load_job(d)
    methods = [m for m in METHODS if not m.endswith('-2s')]
    want = jserve.Scorer(jloaded, methods=methods)(x)
    job = tjobs.load_job(d, device='cpu')
    assert job.model_cfg == flagship_config(tiny=True)
    assert tserve.calibrated_thresholds(job, methods) == \
        jserve.calibrated_thresholds(jloaded, methods)
    scorer = tserve.Scorer(job, methods=methods)
    got = scorer(x, eps=torch.from_numpy(eps))
    assert 0 < got['in_distribution'].sum() < N
    np.testing.assert_array_equal(got['label'], np.asarray(want['label']))
    np.testing.assert_array_equal(got['in_distribution'],
                                  np.asarray(want['in_distribution']))
    for m in methods:
        close(got['scores'][m], np.asarray(want['scores'][m]), 5e-4, m)


def test_port_saved_job_loads_in_jax(x, monkeypatch, tmp_path):
    job = tjobs.new_job(flagship_config(tiny=True), seed=4, device='cpu')
    job.train_history = {'epochs': 2}
    d = str(tmp_path / 'portjob')
    tjobs.save_job(job, d)
    jjob = jjobs.load_job(d)
    assert jjob.model_cfg == graft._flagship_cfg(tiny=True)
    assert jjob.trained == 2
    want_arrays = state_dict_to_jax(job.model)
    got_arrays = jax_arrays(jjob.state)
    assert set(got_arrays) == set(want_arrays)
    for k, v in want_arrays.items():
        assert np.array_equal(got_arrays[k], v), k
    eps = make_eps((3, N, 16), seed=6)
    inject_jax_eps(monkeypatch, eps)
    want = jev.evaluate(jjob.model, jjob.state.variables, jnp.asarray(x), None,
                        rng=jax.random.PRNGKey(0),
                        sigma_state=jjob.state.sigma_state, train=False)
    from joint_vae_tpu_torch.models.evaluate import evaluate
    got = evaluate(job.model, torch.from_numpy(x), sigma_state=job.sigma_state,
                   eps=torch.from_numpy(eps))
    for k, v in want.losses.items():
        close(got.losses[k], v, 5e-4, k)


def test_cli_matches_jax_cli(tmp_path):
    # L=1 and beta=0: the latent is not sampled, so both CLIs see the same z
    cfg = JCVNetConfig(input_shape=(3, 6, 6), num_labels=3, type='cvae',
                       encoder=(16,), decoder=(16,), classifier=(8,),
                       latent_dim=4, latent_sampling=1, test_latent_sampling=2,
                       gamma=10.0, beta=0.0, sigma=JSigmaConfig(value=0.3))
    job = jjobs.new_job(cfg, key=jax.random.PRNGKey(2))
    job.train_history = {'epochs': 1}
    xs = np.random.default_rng(0).uniform(0, 1, (7, 3, 6, 6)).astype(np.float32)
    probe = jserve.Scorer(job, methods=('elbo',),
                          thresholds={'elbo': float('-inf')})(xs)
    job.ood_results = _ood_entry(_gap_thresholds(probe['scores']))
    d = str(tmp_path / 'job')
    jjobs.save_job(job, d)
    npy = str(tmp_path / 'x.npy')
    np.save(npy, xs)

    from joint_vae_tpu.cli.serve import main as jmain
    from joint_vae_tpu_torch.cli.serve import main as tmain
    outs = {}
    for name, main, extra in (('jax', jmain, ['--platform', 'cpu']),
                              ('port', tmain, ['--device', 'cpu'])):
        out = str(tmp_path / (name + '.jsonl'))
        assert main([d, npy, '--batch-size', '4', '--output', out] + extra) == 0
        with open(out) as f:
            outs[name] = [json.loads(s) for s in f]
    assert len(outs['port']) == len(outs['jax']) == 8
    assert outs['port'][-1] == outs['jax'][-1]          # summary line
    assert 0 < outs['port'][-1]['rejected'] < 7
    for got, want in zip(outs['port'][:-1], outs['jax'][:-1]):
        assert set(got) == set(want)
        for k in ('input', 'label', 'in_distribution'):
            assert got[k] == want[k]
        assert got['confidence'] == pytest.approx(want['confidence'], rel=1e-4)
        for m, v in want['scores'].items():
            assert got['scores'][m] == pytest.approx(v, rel=1e-4)


def test_entry_points_never_fall_back_to_cpu(tmp_path, monkeypatch):
    cfg = flagship_config(tiny=True)
    d = str(tmp_path / 'job')
    tjobs.save_job(tjobs.new_job(cfg, device='cpu'), d)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tjobs.load_job(d)
    with pytest.raises(RuntimeError, match='CUDA'):
        tjobs.new_job(cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        tjobs.load_job(d, device='cuda')
    from joint_vae_tpu_torch.cli.serve import main
    npy = str(tmp_path / 'x.npy')
    np.save(npy, np.zeros((1, 3, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match='CUDA'):
        main([d, npy])
    assert tjobs.load_job(d, device='cpu').device == torch.device('cpu')
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert os.path.exists(os.path.join(d, 'state.npz'))


def test_cli_job_number_and_class_names_match_jax(tmp_path, capsys):
    """Both CLIs find a job by its number under --job-dir and name each
    label's class from the training set's registry entry; a number that
    no job has exits with "job N not found"."""
    cfg = JCVNetConfig(input_shape=(3, 6, 6), num_labels=3, type='cvae',
                       encoder=(16,), decoder=(16,), classifier=(8,),
                       latent_dim=4, latent_sampling=1, test_latent_sampling=2,
                       gamma=10.0, beta=0.0, sigma=JSigmaConfig(value=0.3))
    job = jjobs.new_job(cfg, key=jax.random.PRNGKey(2), job_number=42)
    job.train_history = {'epochs': 1}
    job.training_parameters['set'] = 'cifar10'
    jobs = str(tmp_path / 'jobs')
    jjobs.save_job(job, os.path.join(jobs, 'cifar10', 'arch', '000042'))
    npy = str(tmp_path / 'x.npy')
    np.save(npy, np.random.default_rng(1).uniform(
        0, 1, (5, 3, 6, 6)).astype(np.float32))

    from joint_vae_tpu.cli.serve import main as jmain
    from joint_vae_tpu_torch.cli.serve import main as tmain
    outs = {}
    for name, main, extra in (('jax', jmain, ['--platform', 'cpu']),
                              ('port', tmain, ['--device', 'cpu'])):
        out = str(tmp_path / (name + '.jsonl'))
        assert main(['42', npy, '--job-dir', jobs, '--output', out]
                    + extra) == 0
        with open(out) as f:
            outs[name] = [json.loads(s) for s in f]
    assert len(outs['port']) == len(outs['jax']) == 6
    classes = ['airplane', 'automobile', 'bird']
    for got, want in zip(outs['port'][:-1], outs['jax'][:-1]):
        assert got['class'] == want['class'] == classes[got['label']]
        assert got['label'] == want['label']
    with pytest.raises(SystemExit, match='job 7 not found under'):
        tmain(['7', npy, '--job-dir', jobs, '--device', 'cpu'])
