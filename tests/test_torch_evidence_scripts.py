"""The port's evidence scripts (``scripts/torch_*.py``) against the JAX
package's (``scripts/wim_quality.py``, ``wim_inversion_study.py``,
``poscod_quality.py``, ``reproduce_sota.py``, ``prepare_data.py``), on
the CPU:

- the analysis functions on the same numpy inputs: ``rank_auc``,
  ``decompose`` and Poscod's ``auroc`` within 1e-12;
- ``collect_twins`` on a tiny job carried across from JAX, with the
  alternate prior's arrays handed across and the shape-seeded noise of
  ``tests/test_torch_engines.py`` in both packages, within 5e-4;
- the WIM quality pipeline after pretraining
  (``torch_wim_quality.py::tune_and_score``) on the same tiny job, moving
  set and alternate prior: every pre- and post-tuning AUROC within 1e-6
  of the same JAX calls made here (the JAX script's ``main`` writes into
  ``docs/``, so it is not called);
- the reproduction's ``sota_native.csv`` byte-equal to the JAX script's
  from the same numbers (both ``main``s in fixture mode with the
  training, the fine-tune and the engines replaced by the same stand-ins),
  its ``sota_native.json`` tables equal;
- the data preparer's fixtures byte-equal to ``prepare_data.py``'s (the
  MAT header's clock stamp fixed for both), and each fixture set read
  back equal by both packages' loaders;
- Poscod on a bfloat16 model: the repair (the encoder means widened to
  float32 against the float32 head, as JAX promotes them) held to JAX's
  float32 head by the bfloat16 gate of ``tests/test_torch_bf16.py``.
"""

import argparse
import gzip
import json
import os

import jax
import numpy as np
import pytest
import scipy.io.matlab._mio5 as mio5
import torch

import joint_vae_tpu.data.loaders as jloaders
import joint_vae_tpu.data.native as jnative
import joint_vae_tpu.evals.engines as jengines
import joint_vae_tpu.models.evaluate as jev
import joint_vae_tpu.ops.sampling as jsampling
import joint_vae_tpu.train.trainer as jtrainer
from joint_vae_tpu.ft import datasets as jds
from joint_vae_tpu.ft import job as jftjob
from joint_vae_tpu.ft import poscod as jposcod
from joint_vae_tpu.ft import wim as jwim
from joint_vae_tpu.models.cvnet import CVNetConfig as JCVNetConfig
from joint_vae_tpu.ops.priors import PriorConfig as JPriorConfig
from joint_vae_tpu.ops.sigma import SigmaConfig as JSigmaConfig
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.train import optimizers as jopt

import joint_vae_tpu_torch.data.loaders as tloaders
import joint_vae_tpu_torch.data.native as tnative
import joint_vae_tpu_torch.evals.engines as tengines
import joint_vae_tpu_torch.evals.odin as todin
import joint_vae_tpu_torch.models.evaluate as tev
import joint_vae_tpu_torch.train.trainer as ttrainer
from joint_vae_tpu_torch.ft import datasets as tds
from joint_vae_tpu_torch.ft import job as tftjob
from joint_vae_tpu_torch.ft import poscod as tposcod
from joint_vae_tpu_torch.ft import wim as twim
from joint_vae_tpu_torch.save_load import jobs as tjobs

import scripts.poscod_quality as jpq
import scripts.prepare_data as jprep
import scripts.reproduce_sota as jsota
import scripts.torch_poscod_quality as tpq
import scripts.torch_prepare_data as tprep
import scripts.torch_reproduce_sota as tsota
import scripts.torch_wim_inversion_study as twi
import scripts.torch_wim_quality as twq
import scripts.wim_inversion_study as jwi

from test_torch_engines import _noise
from torch_port_util import close

EXACT = 1e-12
TWIN_TOL = 5e-4
AUROC_TOL = 1e-6
GATE_A, GATE_B = 2.0, 2.5e-4          # tests/test_torch_bf16.py
ALT_SEED = 7


def _score_pairs():
    rng = np.random.default_rng(3)
    return {
        'distinct': (rng.normal(1, 1, 40), rng.normal(0, 1, 30)),
        'ties': (rng.integers(0, 5, 40).astype(float),
                 rng.integers(0, 5, 25).astype(float)),
        'separated': (rng.uniform(2, 3, 10), rng.uniform(0, 1, 12)),
        'all_equal': (np.ones(7), np.ones(9)),
        'float32': (rng.normal(0, 1, 33).astype(np.float32),
                    rng.normal(0.3, 1, 21).astype(np.float32)),
    }


@pytest.mark.parametrize('case', sorted(_score_pairs()))
def test_rank_auc_matches_jax(case):
    pos, neg = _score_pairs()[case]
    assert abs(twi.rank_auc(pos, neg) - jwi.rank_auc(pos, neg)) <= EXACT


@pytest.mark.parametrize('case', sorted(_score_pairs()))
def test_poscod_auroc_matches_jax(case):
    ind, ood = _score_pairs()[case]
    assert abs(tpq.auroc(ind, ood) - jpq.auroc(ind, ood)) <= EXACT


def _twins(seed, n):
    rng = np.random.default_rng(seed)
    out = {}
    for k in ('total', 'zdist', 'kl'):
        base = rng.normal(50, 10, n).astype(np.float32)
        out[k] = base
        out[k + '@'] = (base + rng.normal(5, 3, n)).astype(np.float32)
    return out


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_decompose_matches_jax(seed):
    ind, ood = _twins(seed, 40), _twins(seed + 10, 30)
    want = jwi.decompose(ind, ood)
    got = twi.decompose(ind, ood)
    assert set(got) == set(want)
    for k, row in want.items():
        assert set(got[k]) == set(row)
        for m, v in row.items():
            assert abs(got[k][m] - v) <= EXACT, (k, m)


# ---- a tiny job carried across ---------------------------------------------

def _vae(**kw):
    return JCVNetConfig(**dict(dict(
        input_shape=(3, 8, 8), num_labels=4, type='vae', encoder=(16,),
        decoder=(16,), latent_dim=4, latent_sampling=1,
        test_latent_sampling=2, gamma=0.0, beta=0.05,
        sigma=JSigmaConfig(value=0.2), prior=JPriorConfig(dim=4)), **kw))


@pytest.fixture
def shared_noise(monkeypatch):
    """The shape-seeded noise of tests/test_torch_engines.py in both
    packages, and the numpy batcher in both (the same data order)."""
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
    monkeypatch.setattr(jev, 'reparameterize', jax_fake)
    monkeypatch.setattr(jsampling, 'reparameterize', jax_fake)
    monkeypatch.setattr(tev, 'reparameterize', port_fake)
    monkeypatch.setattr(todin, 'reparameterize', port_fake)
    monkeypatch.setattr(jnative, 'available', lambda: False)
    monkeypatch.setattr(tnative, 'available', lambda: False)


def _carried(tmp_path, jcfg, seed=0):
    """A JAX job and the port's job loaded from its directory."""
    jjob = jjobs.new_job(jcfg, jopt.OptimizerConfig(lr=3e-4),
                         key=jax.random.PRNGKey(seed))
    d = str(tmp_path / 'job{}'.format(seed))
    jjobs.save_job(jjob, d)
    return jjob, tjobs.load_job(d, device='cpu')


def _sets(n, seed, name, labels=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, labels, n).astype(np.int32)
    return (jloaders.ArrayDataset(x, y, name),
            tloaders.ArrayDataset(x, y, name))


def _alternate(jjob):
    """JAX's WIM job with the script's alternate prior (PRNGKey 7) and
    that prior's arrays."""
    jw = jwim.WIMJob(job=jjob)
    jw.set_alternate_prior(init_mean=twq.ALTERNATE['init_mean'],
                           num_priors=twq.ALTERNATE['num_priors'],
                           key=jax.random.PRNGKey(ALT_SEED))
    return jw, {k: np.asarray(v) for k, v in jw.alternate_prior_params.items()}


def test_collect_twins_matches_jax(tmp_path, shared_noise):
    jjob, tjob = _carried(tmp_path, _vae())
    jw, arrays = _alternate(jjob)
    tw = twim.WIMJob(job=tjob)
    tw.set_alternate_prior(**twq.ALTERNATE)
    tw.set_alternate_prior_arrays(arrays)
    jd, _ = _sets(21, 5, 'x')
    want = jwi.collect_twins(jw, jd, batch_size=8, L=3)
    got = twi.collect_twins(tw, jd.data, batch_size=8, L=3)
    assert set(got) == set(want) and {'total@', 'kl@', 'zdist@'} <= set(got)
    for k, v in want.items():
        assert got[k].shape == v.shape == (21,)
        close(got[k], v, TWIN_TOL, k)


FT = dict(alpha=0.3, ft_epochs=1, ft_size=36, batch_size=6,
          test_batch_size=8)


def test_wim_quality_pipeline_matches_jax(tmp_path, shared_noise):
    jjob, tjob = _carried(tmp_path, _vae())
    (jtr, ttr), (jte, tte) = _sets(60, 11, 'tiny'), _sets(20, 12, 'tiny')
    oods = [_sets(16, 13, 'ooda'), _sets(16, 14, 'oodb')]
    joods, toods = [o[0] for o in oods], [o[1] for o in oods]
    jmov, tmov = (mod.MixtureDataset(mix={'ood': 0.5, 'ind': 0.5}, length=24,
                                     ood=ood, ind=te)
                  for mod, ood, te in ((jds, joods[0], jte),
                                       (tds, toods[0], tte)))
    # the JAX calls of scripts/wim_quality.py:51-73 at this size
    jpre = jengines.ood_detection_rates(
        jjob, jte, joods, batch_size=FT['test_batch_size'],
        method=twq.PRE_METHODS, update_self_ood=False, recording=False)
    jw, arrays = _alternate(jjob)
    jftjob.finetune(jw, jtr, jmov, jte, joods, epochs=FT['ft_epochs'],
                    alpha=FT['alpha'], train_size=FT['ft_size'],
                    batch_size=FT['batch_size'],
                    test_batch_size=FT['test_batch_size'],
                    ood_methods=twq.POST_METHODS, seed=0)
    jpost = jjob.ood_results[jjob.trained]

    out = twq.tune_and_score(tjob, ttr, tte, toods, tmov, alternate=arrays,
                             **FT)
    for what, got, want in (('pre', out['pre'], jpre),
                            ('post', out['post'], jpost)):
        assert set(got) == set(want) == {'ooda', 'oodb'}, what
        for s, ms in want.items():
            assert set(got[s]) == set(ms), (what, s)
            for m, v in ms.items():
                assert abs(got[s][m]['auc'] - v['auc']) <= AUROC_TOL, (
                    what, s, m, got[s][m]['auc'], v['auc'])
    assert out['finetune']['steps'] == FT['ft_size'] // FT['batch_size']


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_poscod_on_a_bf16_model_matches_jax(tmp_path, shared_noise):
    """The port's Poscod head on a bfloat16 model (which failed on the
    bfloat16 means against the float32 head before the repair) against
    JAX's: err(port bf16, JAX f32) <= 2 err(JAX bf16, JAX f32) + 2.5e-4,
    the head and the llr scores."""
    jte, tte = _sets(24, 21, 'ind')
    (jood, tood), (jood2, tood2) = _sets(24, 22, 'ood'), _sets(16, 23, 'o2')
    heads, scores = {}, {}
    for dtype in ('float32', 'bfloat16'):
        jjob, tjob = _carried(tmp_path / dtype, _vae(compute_dtype=dtype))
        jp = jposcod.PoscodJob(job=jjob).finetune(
            jte, jood, epochs=2, batch_size=8, lr=1e-2, seed=0)
        heads['jax', dtype] = {k: np.asarray(v) for k, v in jp.head.items()}
        scores['jax', dtype] = jp.llr_scores(jood2, 8)
        if dtype == 'bfloat16':
            tp = tposcod.PoscodJob(job=tjob).finetune(
                tte, tood, epochs=2, batch_size=8, lr=1e-2, seed=0)
            assert tp.head['w'].dtype == torch.float32
            heads['port', dtype] = {k: v.numpy() for k, v in tp.head.items()}
            scores['port', dtype] = tp.llr_scores(tood2, 8)
    ref = heads['jax', 'float32']
    for k in ('w', 'b'):
        got = _rel(heads['port', 'bfloat16'][k], ref[k])
        want = _rel(heads['jax', 'bfloat16'][k], ref[k])
        assert got <= GATE_A * want + GATE_B, (k, got, want)
    got = _rel(scores['port', 'bfloat16'], scores['jax', 'float32'])
    want = _rel(scores['jax', 'bfloat16'], scores['jax', 'float32'])
    assert got <= GATE_A * want + GATE_B, ('llr', got, want)


# ---- the reproduction's table ----------------------------------------------

def _fake_rates(sets, methods, base):
    """Engine results with fixed AUCs and rates at each kept TPR."""
    tpr = [0.9, 0.95, 0.99]
    return {s: {m: {'auc': base + 0.01 * i + 0.1 * j, 'tpr': tpr,
                    'fpr': [0.5 - 0.01 * i - 0.1 * j, 0.6 - 0.01 * i, 0.7]}
                for i, m in enumerate(methods)}
            for j, s in enumerate(sets)}


@pytest.fixture
def stand_ins(monkeypatch):
    """The training, the fine-tune and the engines of both packages
    replaced by the same stand-ins: the reproduction's table comes from
    these numbers alone."""
    pre = _fake_rates(['lsunr', 'svhn'], ['elbo', 'zdist', 'kl', 'iws'],
                      0.4)
    post = _fake_rates(['lsunr', 'svhn'], tsota.METHODS, 0.6)

    def engines(job, testset, oodsets, **_):
        return {s.name: pre[s.name] for s in oodsets}

    def fine(wim, trainset, moving, testset, oodsets, save_dir=None, **_):
        os.makedirs(save_dir, exist_ok=True)
        job = wim.job
        job.ood_results.setdefault(job.trained, {})
        for s in oodsets:
            job.ood_results[job.trained][s.name] = post[s.name]
        return wim

    for mod in (jengines, tengines):
        monkeypatch.setattr(mod, 'ood_detection_rates', engines)
    monkeypatch.setattr(jftjob, 'finetune', fine)
    monkeypatch.setattr(tftjob, 'finetune', fine)
    monkeypatch.setattr(jtrainer, 'train_model', lambda job, *a, **k: job)
    monkeypatch.setattr(ttrainer, 'train_model', lambda job, *a, **k: job)
    for mod in (jloaders, tloaders):
        monkeypatch.setattr(mod, 'DATA_DIR', mod.DATA_DIR)
        monkeypatch.setattr(mod, '_cache', {})
    monkeypatch.delenv('JVT_DATA_DIR', raising=False)


def test_sota_table_matches_jax(tmp_path, stand_ins, monkeypatch):
    outs = {}
    for name, mod, extra in (('jax', jsota, []),
                             ('port', tsota, ['--device', 'cpu'])):
        monkeypatch.setattr(mio5.time, 'asctime', lambda: 'fixed')
        out = str(tmp_path / name)
        assert mod.main(['--fixtures', str(tmp_path / 'fx' / name),
                         '--out', out] + extra) == 0
        outs[name] = out
    with open(os.path.join(outs['jax'], 'sota_native.csv'), 'rb') as f:
        want = f.read()
    with open(os.path.join(outs['port'], 'sota_native.csv'), 'rb') as f:
        assert f.read() == want
    reports = {}
    for k, d in outs.items():
        with open(os.path.join(d, 'sota_native.json')) as f:
            reports[k] = json.load(f)
    for key in ('config', 'headline', 'epochs', 'wim_epochs', 'alpha', 'mix',
                'train_size', 'moving_size', 'pre_auroc', 'post',
                'published'):
        assert reports['port'][key] == reports['jax'][key], key


# ---- the data preparer's fixtures ------------------------------------------

@pytest.fixture(scope='module')
def fixture_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('fixtures')
    dirs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mio5.time, 'asctime', lambda: 'Thu Jan  1 00:00:00 1970')
        for name, mod in (('jax', jprep), ('port', tprep)):
            dirs[name] = str(root / name)
            assert mod.cmd_make_fixtures(
                argparse.Namespace(data_dir=dirs[name])) == 0
    return dirs


def _tree(d):
    out = {}
    for p, _, fs in os.walk(d):
        for f in fs:
            with open(os.path.join(p, f), 'rb') as fh:
                out[os.path.relpath(os.path.join(p, f), d)] = fh.read()
    return out


def _comparable(name: str, data: bytes):
    """A file's bytes; a ``.gz`` file's every byte but its header's MTIME
    (bytes 4-7, the second it was written), and its decompressed
    payload."""
    if name.endswith('.gz'):
        return data[:4], data[8:], gzip.decompress(data)
    return data


def test_fixtures_byte_equal_to_jax(fixture_dirs):
    want = _tree(fixture_dirs['jax'])
    got = _tree(fixture_dirs['port'])
    assert sorted(got) == sorted(want) and len(want) > 40
    assert any(f.endswith('.gz') for f in want)
    assert [f for f in want
            if _comparable(f, got[f]) != _comparable(f, want[f])] == []


FIXTURE_SETS = ('cifar10', 'cifar100', 'svhn', 'lsunr', 'lsunc', 'mnist',
                'fashion', 'letters', 'dtd', 'random300k', 'imagenet2')


@pytest.mark.parametrize('name', FIXTURE_SETS)
def test_fixtures_read_back_equal(fixture_dirs, name, monkeypatch):
    got = {}
    for pkg, mod in (('jax', jloaders), ('port', tloaders)):
        monkeypatch.setattr(mod, 'DATA_DIR', fixture_dirs['port'])
        monkeypatch.setattr(mod, '_cache', {})
        splits = ['test'] if name in ('lsunr', 'lsunc', 'dtd',
                                      'random300k') else ['train', 'test']
        got[pkg] = [s for s in mod.get_dataset(name, splits=splits,
                                               require_real=True)
                    if s is not None]
    assert len(got['port']) == len(got['jax']) > 0
    for t, j in zip(got['port'], got['jax']):
        assert not t.synthetic and not j.synthetic and len(t) > 0
        assert t.name == j.name
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.targets, j.targets)
