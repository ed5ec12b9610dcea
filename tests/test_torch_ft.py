"""The port's fine-tuning flow (``ft/``) and ``utils/inspection.py``
against the JAX package, on the CPU and the tiny flagship:

- the datasets (sub-sampling by task and stratified, complements,
  mixtures with a dropped component, estimated labels, the moving set
  with padding and mix padding from the registry): arrays, labels and
  names equal JAX's exactly;
- the file-sentinel scheduler, step for step as JAX's;
- ``finetune`` end to end with shared noise (the shape-seeded noise of
  ``tests/test_torch_engines.py`` in both packages) and the alternate
  prior's arrays handed across: every recorded loss, pre- and
  post-tuning, within 5e-4 (labels and estimated labels equal), the job
  directories' file sets equal, the 'wim' and 'fine_tuning' training
  parameters equal;
- ``wim_prior.npz``: each package reloads the other's job with the arrays
  it was tuned against;
- ``WIMArray`` on JAX-written job directories: rates, AUC, mean and std
  within 1e-6 of JAX's array;
- Poscod's head and ``llr`` scores after two epochs within 1e-4;
- ``utils/inspection`` outputs equal to JAX's, files byte for byte.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import joint_vae_tpu.data.native as jnative
import joint_vae_tpu.models.evaluate as jev
import joint_vae_tpu.ops.sampling as jsampling
from joint_vae_tpu.data import loaders as jloaders
from joint_vae_tpu.ft import array as jarray
from joint_vae_tpu.ft import datasets as jds
from joint_vae_tpu.ft import job as jftjob
from joint_vae_tpu.ft import poscod as jposcod
from joint_vae_tpu.ft import scheduler as jsched
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.train import optimizers as jopt
from joint_vae_tpu.utils import inspection as jinsp

import joint_vae_tpu_torch.data.native as tnative
import joint_vae_tpu_torch.evals.odin as todin
import joint_vae_tpu_torch.models.evaluate as tev
from joint_vae_tpu_torch.data import loaders as tloaders
from joint_vae_tpu_torch.ft import array as tarray
from joint_vae_tpu_torch.ft import datasets as tds
from joint_vae_tpu_torch.ft import job as tftjob
from joint_vae_tpu_torch.ft import poscod as tposcod
from joint_vae_tpu_torch.ft import scheduler as tsched
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.save_load.recorders import LossRecorder
from joint_vae_tpu_torch.utils import inspection as tinsp

from test_torch_engines import _noise
from torch_port_util import close

LOSS_TOL = 5e-4
RATE_TOL = 1e-6
HEAD_TOL = 1e-4
ALT = dict(distribution='gaussian', init_mean=8.0, num_priors=1, seed=3)
FT = dict(epochs=1, alpha=0.1, train_size=36, batch_size=6,
          test_batch_size=8)


@pytest.fixture(autouse=True)
def numpy_batches(monkeypatch):
    monkeypatch.setattr(jnative, 'available', lambda: False)
    monkeypatch.setattr(tnative, 'available', lambda: False)


def _pair(n, seed, name, labels=4, shape=(3, 8, 8)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n,) + shape).astype(np.float32)
    y = rng.integers(0, labels, n).astype(np.int32)
    return jloaders.ArrayDataset(x, y, name), tloaders.ArrayDataset(x, y, name)


def _same(got, want, what=''):
    assert got.name == want.name, what
    assert got.data.dtype == want.data.dtype, what
    np.testing.assert_array_equal(got.data, want.data, err_msg=what)
    np.testing.assert_array_equal(got.targets, want.targets, err_msg=what)


# ---- datasets --------------------------------------------------------------

@pytest.mark.parametrize('length,task,bar', [
    (30, 0, False), (30, 3, False), (30, 2, True), (30, None, False),
    (30, None, True), (0, 1, False), (None, 0, False), (80, 0, True)])
def test_subsampled_dataset_matches_jax(length, task, bar):
    jd, td = _pair(100, 1, 'd')
    want = jds.SubSampledDataset(jd, length, seed=5, task=task)
    got = tds.SubSampledDataset(td, length, seed=5, task=task)
    if bar:
        want.bar()
        got.bar()
    _same(got, want)
    assert len(got) == len(want)


def test_mixture_and_estimated_labels_match_jax():
    (ja, ta), (jb, tb), (jc, tc) = (_pair(60, 1, 'a'), _pair(50, 2, 'b'),
                                    _pair(40, 3, 'c'))
    mix = {'a': 0.25, 'b': 0.75, 'c': 0.0}
    want = jds.MixtureDataset(mix=mix, seed=4, task=1, length=40,
                              a=ja, b=jb, c=jc)
    got = tds.MixtureDataset(mix=mix, seed=4, task=1, length=40,
                             a=ta, b=tb, c=tc)
    _same(got, want, 'mix')
    assert got.mix == want.mix and got.classes == want.classes
    _same(got.extract_subdataset('b'), want.extract_subdataset('b'), 'b')
    _same(got.bar(), want.bar(), 'bar')
    est = np.arange(len(ja)) % 4
    e_want = jds.EstimatedLabelsDataset(ja, est)
    e_got = tds.EstimatedLabelsDataset(ta, est)
    _same(e_got, e_want, 'estimated')
    np.testing.assert_array_equal(e_got.estimated, e_want.estimated)
    assert e_got.estimated.dtype == e_want.estimated.dtype


@pytest.mark.parametrize('kw', [
    dict(oodsets=['svhn', 'cifar100'], moving_size=64, ood_mix=0.5),
    dict(oodsets=['svhn'], moving_size=48, ood_mix=0.25,
         padding_sets=['lsunc'], padding=0.25, mix_padding=0.5, task=2)],
    ids=['ood_mix', 'padding_mix_padding'])
def test_create_moving_set_matches_jax(kw):
    want = jds.create_moving_set('cifar10', seed=9, size=200, **kw)
    got = tds.create_moving_set('cifar10', seed=9, size=200, **kw)
    _same(got, want)
    assert got.component_names == want.component_names
    assert got.mix == want.mix


# ---- scheduler -------------------------------------------------------------

def test_scheduler_matches_jax(tmp_path):
    """Task 1 waits while task 0's sentinel stands; done() lifts it; the
    context manager registers and removes its own."""
    trail = {}
    for name, mod in (('jax', jsched), ('port', tsched)):
        grid = str(tmp_path / name)
        first = mod.Scheduler(grid, seed=3, task=0, poll=0.01)
        second = mod.Scheduler(grid, seed=3, task=1, poll=0.01)
        first.register()
        steps = [sorted(os.listdir(grid)),
                 second.wait_for_turn(timeout=0.05)]
        first.done()
        first.done()
        steps.append(second.wait_for_turn(timeout=0.05))
        with second:
            steps.append(sorted(os.listdir(grid)))
        steps.append(sorted(os.listdir(grid)))
        trail[name] = steps
    assert trail['port'] == trail['jax'] == [
        ['3.0'], False, True, ['3.1'], []]


# ---- the fine-tuning flow --------------------------------------------------

def _datasets():
    """(jax, port) train, moving, test and two OOD sets of the tiny
    flagship's shape."""
    train = _pair(60, 11, 'tiny')
    test = _pair(20, 12, 'tiny')
    oods = [_pair(16, 13, 'ooda'), _pair(16, 14, 'oodb')]
    moving = tuple(mod.MixtureDataset(
        mix={'ind': 0.5, 'ood': 0.5}, seed=2, length=24,
        ind=test[i], ood=oods[0][i]) for i, mod in enumerate((jds, tds)))
    return [tuple(p[i] for p in (train, moving, test)) + ([o[i] for o in oods],)
            for i in range(2)]


@pytest.fixture(scope='module')
def ft_runs(tmp_path_factory):
    """The source job; JAX's fine-tune at seeds 7 and 8 and the port's at
    seed 7, with the shape-seeded noise in both packages."""
    root = tmp_path_factory.mktemp('ft')
    jcfg = graft._flagship_cfg(tiny=True)
    jjob = jjobs.new_job(jcfg, jopt.OptimizerConfig(lr=1e-3),
                         key=jax.random.PRNGKey(0))
    src = str(root / 'source')
    jjobs.save_job(jjob, src)

    def jax_fake(key, mu, log_var, L, dist='gaussian', sampled=True,
                 is_sampled=None):
        sampled = sampled if is_sampled is None else is_sampled
        e = jax.numpy.asarray(_noise((L + 1,) + tuple(mu.shape)))
        z = mu[None] + jax.numpy.exp(0.5 * log_var)[None] * e * float(sampled)
        return z, e[1:]

    def port_fake(mu, log_var, L, dist='gaussian', sampled=True, *,
                  eps=None, generator=None):
        e = torch.from_numpy(_noise((L + 1,) + tuple(mu.shape)))
        z = mu[None] + torch.exp(0.5 * log_var)[None] * e * float(sampled)
        return z, e[1:]

    (jtrain, jmov, jtest, joods), (ttrain, tmov, ttest, toods) = _datasets()
    out = {'src': src}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, 'reparameterize', jax_fake)
        mp.setattr(jsampling, 'reparameterize', jax_fake)
        mp.setattr(tev, 'reparameterize', port_fake)
        mp.setattr(todin, 'reparameterize', port_fake)
        mp.setattr(jnative, 'available', lambda: False)
        mp.setattr(tnative, 'available', lambda: False)
        for seed in (7, 8):
            jw = jftjob.load_wim_job(src, key=jax.random.PRNGKey(ALT['seed']),
                                     **ALT)
            d = str(root / 'jax{}'.format(seed))
            jftjob.finetune(jw, jtrain, jmov, jtest, joods, save_dir=d,
                            seed=seed, **FT)
            out['jax{}'.format(seed)] = (jw, d)
        tw = tftjob.load_wim_job(src, device='cpu', **ALT)
        tw.set_alternate_prior_arrays({k: np.asarray(v) for k, v in
                                       out['jax7'][0].alternate_prior_params
                                       .items()})
        d = str(root / 'port7')
        tftjob.finetune(tw, ttrain, tmov, ttest, toods, save_dir=d, seed=7,
                        **FT)
        out['port7'] = (tw, d)
    out['sets'] = (jtest.name, [o.name for o in joods])
    return out


def _files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


def test_finetune_flow_matches_jax(ft_runs):
    (jw, jd), (tw, td) = ft_runs['jax7'], ft_runs['port7']
    files = _files(jd)
    assert _files(td) == files
    records = [f for f in files if os.path.basename(f).startswith('record-')]
    assert len(records) == 6          # test + 2 OOD sets, before and after
    for f in records:
        want = LossRecorder.load(os.path.join(jd, f))
        got = LossRecorder.load(os.path.join(td, f))
        assert set(got.keys()) == set(want.keys()), f
        assert got.recorded_samples == want.recorded_samples, f
        for k in want.keys():
            w, g = want.get(k), got.get(k)
            if k in ('y_true', 'y_est_already'):
                np.testing.assert_array_equal(g, w, err_msg=f + ' ' + k)
            else:
                close(g, w, LOSS_TOL, '{} {}'.format(f, k))
    post = [f for f in records if '/init/' not in f]
    assert all('y_est_already' in LossRecorder.load(os.path.join(td, f))
               for f in post)
    jtp, ttp = jw.job.training_parameters, tw.job.training_parameters
    assert ttp['wim'] == jtp['wim']
    assert ttp['fine_tuning'] == jtp['fine_tuning']
    assert tw.job.trained == jw.job.trained
    assert set(tw.job.ood_results[0]) == set(jw.job.ood_results[0])
    for s, ms in jw.job.ood_results[0].items():
        assert set(tw.job.ood_results[0][s]) == set(ms)
    assert set(tw.job.testing[0]['already']) == set(
        jw.job.testing[0]['already'])


def test_wim_prior_reloads_across_packages(ft_runs):
    (_, jd), (tw, td) = ft_runs['jax7'], ft_runs['port7']
    want = {k: v.numpy() for k, v in tw.alternate_prior_params.items()}
    from_port = jftjob.load_wim_job(td)
    from_jax = tftjob.load_wim_job(jd, device='cpu')
    for got in (from_port.alternate_prior_params,
                from_jax.alternate_prior_params):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert from_jax.alternate_prior_cfg.params == \
        from_port.alternate_prior_cfg.params
    assert from_jax.job.ood_results        # a WIM job keeps its results


def test_wim_prior_rederived_without_its_file(ft_runs, tmp_path, caplog):
    d = str(tmp_path / 'job')
    shutil.copytree(ft_runs['port7'][1], d)
    os.remove(os.path.join(d, tftjob.WIM_PRIOR_FILE))
    w = tftjob.load_wim_job(d, device='cpu')
    assert 'differ from the JAX package' in caplog.text
    cfg = w.alternate_prior_cfg
    want = tftjob.init_prior_arrays(cfg, np.random.default_rng(ALT['seed']))
    for k, v in want.items():
        np.testing.assert_array_equal(w.alternate_prior_params[k].numpy(), v)


def test_wim_array_matches_jax(ft_runs, tmp_path):
    dirs = [ft_runs['jax7'][1], ft_runs['jax8'][1]]
    test_name, ood_names = ft_runs['sets']
    jarr = jarray.WIMArray(str(tmp_path / 'jarr'))
    jarr.register_jobs(*dirs)
    want = jarr.recompute_rates(jftjob.load_wim_job(dirs[0]), test_name,
                                ood_names)
    tarr = tarray.WIMArray(str(tmp_path / 'tarr'))
    assert tarr.register_jobs(*dirs) == jarr.registered_jobs()
    got = tarr.recompute_rates(tftjob.load_wim_job(dirs[0], device='cpu'),
                               test_name, ood_names)
    assert set(got) == set(want) == set(ood_names)
    for s in want:
        assert set(got[s]) == set(want[s])
        for m, r in want[s].items():
            assert got[s][m]['n'] == r['n'] == 32
            for k in ('auc', 'fpr', 'mean', 'std', 'tpr'):
                close(np.asarray(got[s][m][k]), np.asarray(r[k]), RATE_TOL,
                      '{} {} {}'.format(s, m, k))
    for s in [test_name] + ood_names:
        for init in (True, False):
            if init:
                tarr.merge_recorders(s, init=True)
                jarr.merge_recorders(s, init=True)
            f = os.path.join('samples', 'array', ('pre-' if init else '')
                             + 'record-{}.jvr'.format(s))
            a = LossRecorder.load(str(tmp_path / 'tarr' / f))
            b = LossRecorder.load(str(tmp_path / 'jarr' / f))
            assert a.recorded_samples == b.recorded_samples
            for k in b.keys():
                np.testing.assert_array_equal(a.get(k), b.get(k))


def test_poscod_head_matches_jax(tmp_path):
    jcfg = graft._flagship_cfg(tiny=True)
    jjob = jjobs.new_job(jcfg, key=jax.random.PRNGKey(1))
    d = str(tmp_path / 'job')
    jjobs.save_job(jjob, d)
    (_, _, jtest, joods), (_, _, ttest, toods) = _datasets()
    jp = jposcod.PoscodJob(job=jjob).finetune(jtest, joods[0], epochs=2,
                                              batch_size=8, lr=1e-2, seed=0)
    tp = tposcod.PoscodJob(job=tjobs.load_job(d, device='cpu')).finetune(
        ttest, toods[0], epochs=2, batch_size=8, lr=1e-2, seed=0)
    for k in ('w', 'b'):
        close(tp.head[k], jp.head[k], HEAD_TOL, k)
        assert not np.all(np.asarray(jp.head[k]) == 0)
    close(tp.llr_scores(toods[1], 8), jp.llr_scores(joods[1], 8), HEAD_TOL,
          'llr')
    tposcod.save_poscod_head(tp, d)
    back = tposcod.load_poscod_job(d, device='cpu')
    for k in ('w', 'b'):
        assert torch.equal(back.head[k], tp.head[k])
    jback = jposcod.load_poscod_job(d)
    close(np.asarray(jback.head['w']), tp.head['w'], 0, 'w via JAX')


# ---- utils/inspection ------------------------------------------------------

def _latents(seed=0, n=30, K=6, C=4):
    rng = np.random.default_rng(seed)
    return {'mu': rng.normal(0, 1, (n, K)).astype(np.float32),
            'y': rng.integers(0, C, n).astype(np.int32),
            'centroids': rng.normal(0, 2, (C, K)).astype(np.float32),
            'alternate': rng.normal(8, 1, (1, K)).astype(np.float32)}


def test_inspection_numbers_match_jax():
    mu = _latents()['mu']
    for a, b in zip(tinsp.latent_pca(mu), jinsp.latent_pca(mu)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tinsp.latent_tsne(mu, n_iter=60),
                                  jinsp.latent_tsne(mu, n_iter=60))
    assert tinsp.latent_shift(mu, mu + 0.5) == jinsp.latent_shift(mu, mu + 0.5)


def _bytes(d):
    return {f: open(os.path.join(d, f), 'rb').read() for f in _files(d)}


@pytest.mark.parametrize('model', ['pca', 'tsne'])
def test_proj2d_csv_matches_jax_bytes(model, tmp_path):
    pre = {'tiny': _latents(1), 'ood': {'mu': _latents(2)['mu']}}
    post = {'tiny': _latents(3), 'ood': {'mu': _latents(4)['mu']}}
    classes = ['c{}'.format(i) for i in range(4)]
    for name, mod in (('jax', jinsp), ('port', tinsp)):
        mod.proj2d_csv(pre, post, 'tiny', classes,
                       str(tmp_path / name / 'p.csv'), model=model, N=12)
    assert _bytes(str(tmp_path / 'port')) == _bytes(str(tmp_path / 'jax'))


def test_latent_histograms_match_jax_bytes(tmp_path):
    lat = _latents(5)
    log_var = np.random.default_rng(6).normal(-1, 0.3, lat['mu'].shape)
    for name, mod in (('jax', jinsp), ('port', tinsp)):
        mod.export_latent_histograms(lat['mu'], log_var,
                                     str(tmp_path / name), bins=7, y=lat['y'])
    got, want = _bytes(str(tmp_path / 'port')), _bytes(str(tmp_path / 'jax'))
    assert got == want and len(want) > 3
