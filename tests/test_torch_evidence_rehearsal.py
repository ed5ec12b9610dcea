"""Each evidence script of the port (``scripts/torch_*.py``) rehearsed on
the CPU through its ``main``, as ``chip_smoke.py`` phase 14 runs it on the
card but with a small model (the scripts' ``config`` / ``families``
replaced: an MLP VAE of K=4 on the same 3x32x32 sets) and a few steps:

- it returns 0 and writes only where ``--out`` says (under ``tmp_path``;
  without ``--out`` a CPU run writes no record at all);
- its record has the JAX package's record's keys (``docs/WIM_QUALITY.json``,
  ``WIM_STUDY.json``, ``WIM_STUDY_STRONG.json``, ``POSCOD_QUALITY.json``,
  ``WIM_INVERSION.json``: the same sets, methods and conditions), beside
  the card, the timings, the launches and the band;
- the reproduction in fixture mode writes the reference's table layout;
  the data preparer's fixtures read back as real sets;
- without a card and without ``--device cpu`` each script refuses to run.
"""

import contextlib
import csv
import io
import json
import os

import pytest

import joint_vae_tpu_torch.data.loaders as tloaders
import joint_vae_tpu_torch.data.native as tnative
from joint_vae_tpu_torch.models.cvnet import CVNetConfig
from joint_vae_tpu_torch.ops.priors import PriorConfig
from joint_vae_tpu_torch.ops.sigma import SigmaConfig

import scripts.torch_poscod_quality as tpq
import scripts.torch_prepare_data as tprep
import scripts.torch_reproduce_sota as tsota
import scripts.torch_wim_inversion_study as twi
import scripts.torch_wim_quality as twq
import scripts.torch_wim_study as tws
from scripts.torch_evidence import ROOT, keys_unlike

REHEARSAL = ['--device', 'cpu', '--epochs', '1', '--train-size', '512',
             '--test-size', '128', '--ft-size', '256', '--ft-epochs', '1']


def _small(dtype, num_labels=10, **kw):
    d = dict(input_shape=(3, 32, 32), num_labels=num_labels, type='vae',
             encoder=(16,), decoder=(16,), latent_dim=4, latent_sampling=1,
             test_latent_sampling=2, gamma=0.0, beta=0.05,
             sigma=SigmaConfig(value=0.2), prior=PriorConfig(dim=4),
             compute_dtype=dtype)
    d.update(kw)
    return CVNetConfig(**d)


def _small_families(dtype):
    return {
        'gaussian': dict(cfg=_small(dtype),
                         alt=dict(init_mean=6.0, num_priors=1)),
        'tilted': dict(
            cfg=_small(dtype, beta=1.0, sigma=SigmaConfig(value=0.7071),
                       encoder_forced_variance=1.0,
                       prior=PriorConfig(dim=4, distribution='tilted',
                                         tau=20.0, init_mean=20.0)),
            alt=dict(distribution='tilted', tau=20.0, init_mean=0.0,
                     num_priors=1))}


@pytest.fixture(autouse=True)
def small_models(monkeypatch):
    monkeypatch.setattr(twq, 'config', lambda dt: _small(dt))
    monkeypatch.setattr(tws, 'config', lambda dt: _small(dt, 8))
    monkeypatch.setattr(tpq, 'config', lambda dt: _small(dt, 8))
    monkeypatch.setattr(twi, 'families', _small_families)
    monkeypatch.setattr(tnative, 'available', lambda: False)


def _reference(name):
    with open(os.path.join(ROOT, 'docs', name)) as f:
        return json.load(f)


# (script, extra flags, record key, the JAX record)
CASES = {
    'wim_quality': (twq, ['--dtype', 'float32', 'bfloat16'],
                    ['float32', 'bfloat16'], 'WIM_QUALITY.json'),
    'wim_study': (tws, ['--dtype', 'float32'], ['float32'],
                  'WIM_STUDY.json'),
    'wim_study_strong': (tws, ['--dtype', 'bfloat16', '--strong'],
                         ['strong-bfloat16'], 'WIM_STUDY_STRONG.json'),
    'poscod_quality': (tpq, ['--dtype', 'float32'], ['float32'],
                       'POSCOD_QUALITY.json'),
    'wim_inversion': (twi, [], ['bfloat16'], 'WIM_INVERSION.json'),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_rehearsal_record_has_the_jax_keys(case, tmp_path):
    mod, flags, keys, reference = CASES[case]
    out = tmp_path / 'record.json'
    assert mod.main(REHEARSAL + flags + ['--out', str(out)]) == 0
    assert os.listdir(tmp_path) == ['record.json']
    with open(out) as f:
        record = json.load(f)
    assert sorted(record['runs']) == sorted(keys)
    assert record['device'] == 'cpu' and record['torch']
    ref = _reference(reference)
    for key in keys:
        run = record['runs'][key]
        assert keys_unlike(run, ref) == [], key
        assert run['backend'] == 'cpu'
        assert run['band_met']
        assert {k: run['band'][k] for k in mod.BAND} == mod.BAND
        assert run['seconds'] > 0


def test_cpu_run_without_out_writes_no_record(tmp_path, monkeypatch):
    docs = os.path.join(ROOT, 'docs')
    before = {f: os.path.getmtime(os.path.join(docs, f))
              for f in os.listdir(docs)}
    monkeypatch.chdir(tmp_path)
    assert twq.main(REHEARSAL + ['--dtype', 'float32']) == 0
    after = {f: os.path.getmtime(os.path.join(docs, f))
             for f in os.listdir(docs)}
    assert after == before
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize('mod', [twq, tws, tpq, twi],
                         ids=['wim_quality', 'wim_study', 'poscod_quality',
                              'wim_inversion'])
def test_no_card_without_device_cpu_refuses(mod, tmp_path, monkeypatch):
    monkeypatch.setattr('torch.cuda.is_available', lambda: False)
    with pytest.raises(SystemExit, match='no CUDA card'):
        mod.main(['--out', str(tmp_path / 'r.json')])
    assert not os.path.exists(tmp_path / 'r.json')


@pytest.fixture
def data_dir_restored(monkeypatch):
    monkeypatch.setattr(tloaders, 'DATA_DIR', tloaders.DATA_DIR)
    monkeypatch.setattr(tloaders, '_cache', {})
    monkeypatch.setenv('JVT_DATA_DIR', tloaders.DATA_DIR)


def test_reproduce_sota_fixture_rehearsal(tmp_path, data_dir_restored):
    out = str(tmp_path / 'sota')
    assert tsota.main(['--fixtures', str(tmp_path / 'fx'), '--out', out,
                       '--device', 'cpu']) == 0
    with open(os.path.join(out, 'sota_native.csv')) as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows] == ['set', 'method', 'measures',
                                    'vae (published)', 'vae (this run)']
    assert rows[0][1:] == ['lsunr'] * 6 + ['svhn'] * 6
    assert rows[3][5] == '94.1' and rows[3][11] == '99.1'
    for i in (5, 6, 11, 12):
        assert 0.0 <= float(rows[4][i]) <= 100.0
    with open(os.path.join(out, 'sota_native.json')) as f:
        rep = json.load(f)
    for s in ('lsunr', 'svhn'):
        assert set(rep['post'][s]) == set(tsota.METHODS)
    assert rep['device'] == 'cpu'
    assert sorted(os.listdir(out)) == ['pretrained', 'sota_native.csv',
                                       'sota_native.json', 'wim-lsunr',
                                       'wim-svhn']


def test_prepare_data_fixtures_verify_as_real(tmp_path, data_dir_restored):
    fx = str(tmp_path / 'fx')
    assert tprep.main(['make-fixtures', '--data-dir', fx]) == 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert tprep.main(['verify', '--data-dir', fx]) == 0
    status = dict(line.split(None, 1) for line in
                  text.getvalue().splitlines())
    assert sorted(n for n, v in status.items() if not v.startswith('real')) \
        == ['imagenet12', 'imagenet1k', 'imagenet20']
    assert status['cifar10'] == 'real (16 items)'
