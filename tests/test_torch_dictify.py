"""The port's flat model dicts and results planner
(``save_load/dictify.py``) and its early-stopping helpers
(``utils/testing.py``) against the JAX package's.

Job directories are written by the JAX package (``new_job`` without a
state, so only the JSON files): a cvae, a vae with an rmse sigma, a vib,
a held-out-classes cvae and a WIM-tuned one, each with results drawn from
a numpy seed at several epochs (accuracy and misclassification entries
per predict method, OOD grids over the set's companions, histories with
and without validation) and record files under ``samples/<epoch>/``
holding a chosen subset of loss components.  Both packages ghost-load
each directory; ``make_dict_from_model`` over every ``wanted_epoch``
form ('last', 'min-loss', ints near and far, with and without a
tolerance), ``oodsets`` restrictions and ``tpr`` levels, and
``available_results`` over tier subsets and method restrictions, must
give the same JSON text.
"""

import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from joint_vae_tpu.models.cvnet import CVNetConfig as JConfig
from joint_vae_tpu.ops.priors import PriorConfig
from joint_vae_tpu.ops.sigma import SigmaConfig
from joint_vae_tpu.save_load import dictify as jd
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.save_load.recorders import LossRecorder as JRecorder
from joint_vae_tpu.utils import testing as jtesting

from joint_vae_tpu_torch.save_load import dictify as td
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.utils import testing as ttesting

KEPT = [0.9, 0.91, 0.92, 0.93, 0.94, 0.95, 0.96, 0.97, 0.98, 0.99]


def _cfg(kind):
    base = dict(input_shape=(1, 28, 28), num_labels=10, encoder=(16,),
                decoder=(16,), classifier=(8,), latent_dim=4,
                test_latent_sampling=2, prior=PriorConfig(dim=4))
    if kind == 'vae':
        return JConfig(type='vae', sigma=SigmaConfig(is_rmse=True), **base)
    if kind == 'vib':
        return JConfig(type='vib', **base)
    return JConfig(type='cvae', sigma=SigmaConfig(value=0.25), gamma=10.0,
                   **base)


def _rates(rng, n):
    fpr = np.sort(rng.uniform(0, 1, len(KEPT))).tolist()
    return {'n': n, 'epochs': 0, 'auc': float(rng.uniform(0.4, 1)),
            'tpr': KEPT, 'fpr': fpr, 'mean': float(rng.normal()),
            'std': float(rng.uniform(0.1, 2))}


def _write_job(root, name, kind, dataset, seed, epochs=(0, 3, 5),
               validation=False, wim=False):
    rng = np.random.default_rng(seed)
    cfg = _cfg(kind)
    job = jjobs.new_job(cfg, job_number=seed)
    tp = job.training_parameters
    tp.update({'set': dataset, 'epochs': max(epochs) + 2, 'batch_size': 32,
               'validation': 100 if validation else 0})
    if wim:
        tp['wim'] = {'distribution': 'gaussian', 'init_mean': 0.5,
                     'sets': ['fashion', 'mnist90'], 'mix': 0.5}
        tp['fine_tuning'] = [{'type': 'wim', 'alpha': 0.1, 'train_size': 64,
                              'moving_size': 8, 'from_epoch': 3}]
    ood_sets = ['fashion', 'mnist90', 'letters'] if 'mnist' in dataset \
        else ['mnist']
    hist = {'epochs': max(epochs)}
    for e in range(1, max(epochs) + 1):
        h = {'lr': 1e-3 / e,
             'train_loss': {'total': float(rng.normal(5)), 'kl': 1.0},
             'test_loss': {'total': float(rng.normal(5)),
                           'iws': float(-rng.uniform(50, 80)),
                           'zdist': float(rng.uniform(1, 4))},
             'test_measures': {'rmse': float(rng.uniform(0, 1)),
                               'sigma': 0.25}}
        if validation and e > 1:
            h['validation_loss'] = {'total': float(rng.normal(5))}
        hist[e] = h
    job.train_history = hist
    for e in epochs[1:]:
        n = int(rng.choice([64, 128]))
        entry = {}
        for pm in cfg.predict_methods:
            entry[pm] = {'n': n, 'epochs': e, 'accuracy': float(rng.uniform())}
            for mm in ('iws', 'kl', 'baseline-10'):
                entry[pm][mm] = _rates(rng, n)
        job.testing[e] = entry
        job.ood_results[e] = {
            s: {m: _rates(rng, n) for m in ('iws', 'elbo', 'iws-2s', 'kl')
                [:int(rng.integers(1, 5))]}
            for s in ood_sets[:int(rng.integers(1, 4))]}
    d = os.path.join(root, name)
    jjobs.save_job(job, d)
    for e, comps in ((epochs[-1], ('total', 'iws', 'kl', 'logits')),
                     (epochs[1], ('iws',))):
        for s in [dataset] + ood_sets[:2]:
            rec = JRecorder(4)
            rec.append_batch(y_true=np.arange(4),
                             **{c: rng.normal(size=(10, 4)).astype(np.float32)
                                for c in comps})
            rec.save(os.path.join(d, 'samples', '{:04d}'.format(e),
                                  'record-{}.jvr'.format(s)))
    return d


@pytest.fixture(scope='module')
def job_dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('dictify'))
    return [_write_job(root, 'cvae', 'cvae', 'mnist', 1),
            _write_job(root, 'vae', 'vae', 'fashion', 2, validation=True),
            _write_job(root, 'vib', 'vib', 'mnist', 3, epochs=(0, 2)),
            _write_job(root, 'heldout', 'cvae', 'mnist-012', 4),
            _write_job(root, 'wim', 'cvae', 'mnist', 5, validation=True,
                       wim=True)]


def _same(got, want):
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert list(got) == list(want)


EPOCHS = ['last', 'min-loss', 0, 3, 4, 5, 9, 40]


@pytest.mark.parametrize('wanted', EPOCHS, ids=str)
def test_make_dict_from_model_equal(job_dirs, wanted):
    for d in job_dirs:
        jjob, tjob = jjobs.load_job(d, ghost=True), tjobs.load_job(d, ghost=True)
        if wanted == 'min-loss':
            assert ttesting.cache_early_stopping(tjob) == \
                jtesting.cache_early_stopping(jjob)
        for kw in ({}, {'epoch_tolerance': 1}, {'tpr': 0.9},
                   {'oodsets': ['fashion']}, {'oodsets': ['mnist90', 'svhn']},
                   {'oodsets': [], 'tpr': 0.99, 'epoch_tolerance': 0}):
            _same(td.make_dict_from_model(tjob, directory=d,
                                          wanted_epoch=wanted, **kw),
                  jd.make_dict_from_model(jjob, directory=d,
                                          wanted_epoch=wanted, **kw))


@pytest.mark.parametrize('where', [('json', 'recorders', 'compute'),
                                   ('json',), ('recorders',), ('compute',),
                                   ('json', 'recorders')], ids='+'.join)
def test_available_results_equal(job_dirs, where):
    for d in job_dirs:
        jjob, tjob = jjobs.load_job(d, ghost=True), tjobs.load_job(d, ghost=True)
        for kw in ({}, {'wanted_epoch': 3, 'epoch_tolerance': 2},
                   {'wanted_epoch': 0, 'epoch_tolerance': 10 ** 9},
                   {'oodsets': ['fashion'], 'ood_methods': ['iws', 'kl'],
                    'predict_methods': [], 'misclass_methods': ['iws']},
                   {'testset': 'fashion', 'oodsets': None}):
            _same(td.available_results(tjob, where=where, **kw),
                  jd.available_results(jjob, where=where, **kw))


history_entry = st.fixed_dictionaries({}, optional={
    'validation_loss': st.fixed_dictionaries(
        {}, optional={'total': st.floats(-5, 5), 'kl': st.floats(0, 3)}),
    'validation_measures': st.fixed_dictionaries(
        {}, optional={'mse': st.floats(0, 1)}),
    'test_loss': st.fixed_dictionaries(
        {}, optional={'total': st.floats(-5, 5), 'kl': st.floats(0, 3)}),
    'test_measures': st.fixed_dictionaries(
        {}, optional={'mse': st.floats(0, 1), 'rmse': st.floats(0, 1)})})


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(hist=st.dictionaries(st.integers(-1, 8), history_entry, max_size=7),
       metric=st.sampled_from(['total', 'kl', 'mse', 'rmse']),
       epochs=st.one_of(st.none(), st.sets(st.integers(-1, 8))),
       results=st.sets(st.integers(-1, 8), max_size=4))
def test_early_stopping_equal(hist, metric, epochs, results):
    """``early_stopping_epoch`` over drawn histories (families at any
    epoch, missing metrics, candidate restrictions) and
    ``cache_early_stopping`` over drawn result epochs, both packages alike
    (the family is chosen by a scan over every history epoch)."""
    assert (ttesting.early_stopping_epoch(hist, metric=metric, epochs=epochs)
            == jtesting.early_stopping_epoch(hist, metric=metric,
                                             epochs=epochs))

    class Job:
        def __init__(self):
            self.train_history = dict(hist)
            self.testing = {e: {'iws': {}} for e in results}
            self.ood_results = {}
            self.training_parameters = {}
    tj, jj = Job(), Job()
    assert (ttesting.cache_early_stopping(tj, metric=metric)
            == jtesting.cache_early_stopping(jj, metric=metric))
    assert tj.training_parameters == jj.training_parameters


def test_arch_code_is_a_digest(job_dirs):
    """``arch_code`` is the zlib digest of ``arch``, the same in every
    process (not the salted ``hash``)."""
    import zlib
    d = td.make_dict_from_model(tjobs.load_job(job_dirs[0], ghost=True))
    assert d['arch_code'] == format(zlib.crc32(d['arch'].encode()), 'x')
    assert td.DICT_SCHEMA_VERSION == jd.DICT_SCHEMA_VERSION == 3
