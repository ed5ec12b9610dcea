"""The port's model-query filters (``utils/filters.py``) and the test
CLI's filter plumbing (``cli/test.py``: ``read_filter_file``,
``filters_from_args``) against the JAX package's.

hypothesis draws filter strings over the whole grammar (single values,
comma and space lists, ``not``, ``a...b`` intervals with open ends, the
empty string and ``None``) for every key type of the schema (int, float,
str, bool) and under its aliases, and values to filter (typed, of the
wrong type, missing, list-valued); both packages must give the same
answer.  INI files (sections OR'd, keys by alias and case, an
``[options]`` section) go through both ``read_filter_file``.
"""

import argparse
import os

import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from joint_vae_tpu.cli import test as jtest
from joint_vae_tpu.utils import filters as jf

from joint_vae_tpu_torch.cli import test as ttest
from joint_vae_tpu_torch.utils import filters as tf

SETTINGS = settings(max_examples=150, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow,
                                           HealthCheck.function_scoped_fixture])
TYPES = {'int': int, 'float': float, 'str': str, 'bool': bool}

token = {
    'int': st.integers(-20, 20).map(str),
    'float': st.one_of(st.integers(-5, 5).map(str),
                       st.sampled_from(['0.5', '1e-3', '2.25', '-0.1'])),
    'str': st.sampled_from(['cvae', 'vae', 'mnist', 'rmse', 'a1']),
    'bool': st.sampled_from(['true', 'false', 'True', 'FALSE', 'x']),
}


@st.composite
def filter_string(draw, kind):
    form = draw(st.sampled_from(['single', 'list', 'interval', 'empty',
                                 'none']))
    if form == 'none':
        return None
    if form == 'empty':
        s = ''
    elif form == 'single':
        s = draw(token[kind])
    elif form == 'list':
        toks = draw(st.lists(token[kind], min_size=2, max_size=4))
        sep = draw(st.sampled_from([',', ' ', ', ', ' , ']))
        s = sep.join(toks)
    else:
        lo = draw(st.one_of(st.just(''), token[kind]))
        hi = draw(st.one_of(st.just(''), token[kind]))
        s = lo + draw(st.sampled_from(['..', '...', '....'])) + hi
    if draw(st.booleans()):
        s = draw(st.sampled_from(['not ', 'not  ', 'NOT '])) + s
    return s


value = st.one_of(st.none(), st.integers(-20, 20), st.floats(-20, 20),
                  st.booleans(), st.sampled_from(['cvae', 'vae', 'mnist']),
                  st.lists(st.integers(-3, 3), max_size=3))


@SETTINGS
@given(data=st.data(), kind=st.sampled_from(sorted(TYPES)))
def test_param_filter_grammar(data, kind):
    s = data.draw(filter_string(kind))
    typ = TYPES[kind]
    try:
        want = jf.ParamFilter.from_string(s, type=typ)
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e)):
            tf.ParamFilter.from_string(s, type=typ)
        return
    got = tf.ParamFilter.from_string(s, type=typ)
    assert str(got) == str(want)
    for v in data.draw(st.lists(value, min_size=1, max_size=6)):
        assert got.filter(v) == want.filter(v), (s, kind, v)


model = st.fixed_dictionaries({
    'job': st.integers(1, 9), 'set': st.sampled_from(['mnist', 'fashion']),
    'type': st.sampled_from(['cvae', 'vae']),
    'beta': st.sampled_from([0.5, 1.0, 2.0]),
    'K': st.sampled_from([4, 16]), 'latent_dim': st.sampled_from([4, 16]),
    'sigma': st.sampled_from([0.1, 0.5, 'rmse']),
    'finished': st.booleans(), 'heldout': st.just([1, 2])})

keys = st.sampled_from(['job', 'job_number', 'set', 'dataset', 'type',
                        'beta', 'K', 'latent_dim', 'sigma', 'finished',
                        'heldout', 'h/o', 'unknown_key'])


@SETTINGS
@given(data=st.data())
def test_filters_from_dict_and_metafilter(data):
    d = {}
    for k in data.draw(st.lists(keys, min_size=1, max_size=4, unique=True)):
        spec = jf.FILTER_KEYS.get(k) or next(
            (s for s in jf.FILTER_KEYS.values() if k in s.get('aliases', ())),
            {'type': str})
        kind = {v: k_ for k_, v in TYPES.items()}[spec['type']]
        d[k] = data.draw(filter_string(kind)) or ''
    try:
        want = jf.filters_from_dict(d)
    except (ValueError, TypeError):
        with pytest.raises((ValueError, TypeError)):
            tf.filters_from_dict(d)
        return
    got = tf.filters_from_dict(d)
    assert sorted(got) == sorted(want)
    other_j, other_t = jf.filters_from_dict({'type': 'vae'}), \
        tf.filters_from_dict({'type': 'vae'})
    for m in data.draw(st.lists(model, min_size=1, max_size=5)):
        assert got.filter(m) == want.filter(m)
        for op in ('and', 'or'):
            assert (tf.MetaFilter(op, got, other_t).filter(m)
                    == jf.MetaFilter(op, want, other_j).filter(m))


def test_schema_equal():
    assert tf.get_filter_keys() == jf.get_filter_keys()


ini_key = st.sampled_from(['type', 'beta', 'K', 'L', 'l', 'dataset',
                           'latent-dim', 'Latent_Sampling', 'sigma', 'job'])


@SETTINGS
@given(data=st.data())
def test_read_filter_file(tmp_path, data):
    lines = []
    for i in range(data.draw(st.integers(1, 3))):
        lines.append('[group{}]'.format(i))
        for k in data.draw(st.lists(ini_key, min_size=1, max_size=3,
                                    unique=True)):
            kind = ('str' if k in ('type', 'dataset')
                    else 'float' if k in ('beta', 'sigma') else 'int')
            lines.append('{} = {}'.format(k, data.draw(filter_string(kind))
                                          or ''))
    if data.draw(st.booleans()):
        lines += ['[options]', 'mnist ood = fashion mnist90',
                  'ood_methods = iws kl', 'predict_methods = iws']
    path = str(tmp_path / 'f{}.ini'.format(data.draw(st.integers(0, 10**6))))
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    try:
        jflt, jopts = jtest.read_filter_file(path)
    except (ValueError, TypeError):
        with pytest.raises((ValueError, TypeError)):
            ttest.read_filter_file(path)
        return
    tflt, topts = ttest.read_filter_file(path)
    assert topts == jopts
    for m in data.draw(st.lists(model, min_size=1, max_size=5)):
        assert tflt.filter(m) == jflt.filter(m)
    os.unlink(path)


def test_filter_flags_are_the_schema():
    """Both CLIs build the same filter flags from the schema and read
    them into the same filters."""
    argv = ['--type', 'cvae', '--beta', '1...2', '-K', '4', '16',
            '--dataset', 'not', 'fashion', '--filter', 'L=1']
    ja = argparse.ArgumentParser()
    jtest.add_filter_args(ja)
    ja.add_argument('--filter', nargs='*', default=[])
    ta = argparse.ArgumentParser()
    ttest.add_filter_args(ta)
    ta.add_argument('--filter', nargs='*', default=[])
    assert ({a.dest for a in ja._actions} == {a.dest for a in ta._actions})
    jflt = jtest.filters_from_args(ja.parse_args(argv))
    tflt = ttest.filters_from_args(ta.parse_args(argv))
    for m in ({'type': 'cvae', 'beta': 1.5, 'latent_dim': 4, 'set': 'mnist',
               'latent_sampling': 1},
              {'type': 'cvae', 'beta': 1.5, 'latent_dim': 4,
               'set': 'fashion', 'latent_sampling': 1},
              {'type': 'vae', 'beta': 3.0, 'latent_dim': 8}):
        assert tflt.filter(m) == jflt.filter(m)
