"""The port's result tables (``results/frame.py``, ``results/tables.py``,
``results/texify.py``) against the JAX package's pandas ones.

Fleets of flat model dicts are drawn by hypothesis: index values with
ties and missing entries, arch and train keys of mixed types, accuracy
per predict method, best-method and per-method OOD grids, measures.
``results_dataframe`` (both ``sort_index`` settings, ``tpr``/``tnr``,
method expansion), ``auto_remove_index`` and ``agg_results`` must equal
the pandas frames cell for cell, with the same index (names, values,
order) and the same column keys in the same order; the ``.tab`` and
``.tex`` files written from them, and ``export_losses``' file, must be
byte-equal.
"""

import os

import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, example, given, settings, strategies as st

from joint_vae_tpu.results import tables as jtables
from joint_vae_tpu.results import texify as jtexify
from joint_vae_tpu.save_load.recorders import LossRecorder as JRecorder

from joint_vae_tpu_torch.results import tables as ttables
from joint_vae_tpu_torch.results import texify as ttexify
from joint_vae_tpu_torch.results.frame import Frame, infer_kind, is_missing
from joint_vae_tpu_torch.save_load.recorders import LossRecorder

SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow,
                                           HealthCheck.function_scoped_fixture])
SETS = ['fashion', 'mnist90', 'svhn', 'average']
METHODS = ['iws', 'kl', 'baseline-10', 'iws-2s']
PMS = ['iws', 'closest', 'esty']

rate = st.one_of(st.none(), st.floats(0, 1, allow_nan=False),
                 st.sampled_from([0.0, 0.5, 1.0, 0.1234567]))


@st.composite
def model_dict(draw, job):
    d = {'job': job,
         'type': draw(st.sampled_from(['cvae', 'vae', 'vib'])),
         'set': draw(st.sampled_from(['mnist', 'fashion', None])),
         'arch_code': draw(st.sampled_from(['a1', 'b2'])),
         'sigma_train': draw(st.sampled_from(['constant', 'rmse'])),
         'beta': draw(st.sampled_from([1.0, 2.0, 0.5, None])),
         'gamma': draw(st.sampled_from([100.0, 10.0])),
         'latent_dim': draw(st.sampled_from([16, 32])),
         'features': draw(st.sampled_from(['none', 'conv32'])),
         'encoder': '512', 'decoder': draw(st.sampled_from(['512', ''])),
         'upsampler': 'none', 'classifier': 'none', 'prior': 'gaussian',
         'depth': draw(st.sampled_from([2, 3])),
         'width': draw(st.sampled_from([1024, None])),
         'sigma': draw(st.sampled_from([0.1, 0.25, 'rmse'])),
         'latent_sampling': 1, 'optim': 'adam',
         'lr': draw(st.sampled_from([1e-4, 1e-3])),
         'batch_size': draw(st.sampled_from([128, None])),
         'done': draw(st.integers(0, 10)), 'epochs': 10,
         'finished': draw(st.booleans())}
    if draw(st.booleans()):
        d['accuracy_epoch'] = d['done']
    for pm in PMS:
        v = draw(rate)
        if v is not None:
            d['accuracy_' + pm] = v
    accs = [v for k, v in d.items() if k.startswith('accuracy_')
            and k != 'accuracy_epoch']
    if accs:
        d['accuracy'] = max(accs)
    for s in draw(st.lists(st.sampled_from(SETS), unique=True, max_size=3)):
        if s != 'average':
            d['ood_{}_method'.format(s)] = draw(st.sampled_from(METHODS))
        for k in ('auc', 'fpr95', 'fpr90'):
            v = draw(rate)
            if v is not None:
                d['ood_{}_{}'.format(s, k)] = v
        for m in draw(st.lists(st.sampled_from(METHODS), unique=True,
                               max_size=2)):
            for k in ('auc', 'fpr95'):
                v = draw(rate)
                if v is not None:
                    d['ood_{}_{}_{}'.format(s, m, k)] = v
    for k in ('mse', 'rmse', 'test_loss'):
        v = draw(st.one_of(st.none(), st.floats(-10, 10)))
        if v is not None:
            d[k] = v
    return d


@st.composite
def fleet(draw):
    n = draw(st.integers(1, 7))
    jobs = draw(st.permutations(list(range(1, n + 1))))
    if draw(st.booleans()) and n > 1:
        jobs[-1] = jobs[0]              # a duplicate row (--all-epochs)
    return [draw(model_dict(j)) for j in jobs]


def _same_cell(got, want):
    if is_missing(got) or (not isinstance(want, (list, tuple))
                           and pd.isna(want)):
        return is_missing(got) and pd.isna(want)
    if isinstance(want, (float, np.floating)):
        return isinstance(got, float) and got == float(want)
    return got == want and type(got) is not float


def assert_frame_equal(f: Frame, df: pd.DataFrame):
    if df.empty and df.shape == (0, 0):
        assert f.empty and len(f) == 0
        return
    assert list(f.index_names) == list(df.index.names)
    assert f.columns == [c if isinstance(c, tuple) else (c,)
                         for c in df.columns]
    want_index = [k if isinstance(k, tuple) else (k,) for k in df.index]
    assert len(f.index) == len(want_index)
    for got, want in zip(f.index, want_index):
        assert all(_same_cell(g, w) for g, w in zip(got, want)), (got, want)
    for j, col in enumerate(df.columns):
        want_col = df[col].tolist()
        got_col = [r[j] for r in f.rows]
        for g, w in zip(got_col, want_col):
            assert _same_cell(g, w), (col, g, w, df[col].dtype)


def _write_both(f, df, tmp, name, best=False):
    paths = {}
    for pkg, fn, table in (('jax', jtexify.texify_test_results_df, df),
                           ('torch', ttexify.texify_test_results_df, f)):
        tex = os.path.join(tmp, '{}-{}.tex'.format(name, pkg))
        tab = os.path.join(tmp, '{}-{}.tab'.format(name, pkg))
        fn(table, tex_file=tex, tab_file=tab, best_in_group=best)
        paths[pkg] = (tex, tab)
    if df.empty:
        return
    for a, b in zip(paths['jax'], paths['torch']):
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read(), (a, b)


@SETTINGS
@given(models=fleet(), sort=st.booleans(), tpr=st.sampled_from([95, 90]),
       tnr=st.booleans(), expand=st.sampled_from(['first', 'all', ['iws']]),
       measures=st.booleans(), best=st.booleans())
def test_results_dataframe_matches_pandas(tmp_path, models, sort, tpr, tnr,
                                          expand, measures, best):
    kw = dict(tpr=tpr, tnr=tnr, sort_index=sort, ood_methods=expand,
              predict_methods=expand, measures=measures)
    df = jtables.results_dataframe(models, **kw)
    f = ttables.results_dataframe(models, **kw)
    assert_frame_equal(f, df)
    _write_both(f, df, str(tmp_path), 'raw', best)
    keep = ['job', 'type']
    df2, f2 = jtables.auto_remove_index(df, keep), ttables.auto_remove_index(
        f, keep)
    assert_frame_equal(f2, df2)
    _write_both(f2, df2, str(tmp_path), 'auto', best)
    df3, f3 = jtables.auto_remove_index(df), ttables.auto_remove_index(f)
    assert_frame_equal(f3, df3)
    for frame_j, frame_t in ((df, f), (df2, f2), (df3, f3)):
        aj, at = jtables.agg_results(frame_j), ttables.agg_results(frame_t)
        assert_frame_equal(at, aj)
        _write_both(at, aj, str(tmp_path), 'agg', best)


@SETTINGS
@given(values=st.lists(st.one_of(
    st.none(), st.floats(allow_nan=True, allow_infinity=False, width=64),
    st.integers(-5, 5), st.booleans(), st.sampled_from(['a', 'b c', '"q"'])),
    min_size=1, max_size=6))
@example(values=[None, float('nan')])   # missing cells only, one a NaN
def test_column_kinds_and_csv_follow_pandas(tmp_path, values):
    """One column of mixed cells: its kind, iteration values and csv
    bytes as pandas infers and writes them."""
    records = [{('index', 'job'): i, ('g', 'v'): v}
               for i, v in enumerate(values)]
    df = pd.DataFrame(records)
    df.columns = pd.MultiIndex.from_tuples(df.columns)
    df = df.set_index([('index', 'job')])
    df.index.names = ['job']
    f = Frame.from_records(records, index=[('index', 'job')])
    kind = infer_kind(values)
    dt = df[('g', 'v')].dtype
    assert {'int': 'int64', 'float': 'float64', 'bool': 'bool',
            'str': 'str', 'object': 'object'}[kind] == str(dt), (kind, dt)
    assert_frame_equal(f, df)
    a, b = str(tmp_path / 'a.tab'), str(tmp_path / 'b.tab')
    df.to_csv(a, sep=' ', float_format='%.4g')
    f.to_csv(b, sep=' ', float_format='%.4g')
    assert open(a, 'rb').read() == open(b, 'rb').read()


@SETTINGS
@given(groups=st.lists(st.tuples(
    st.sampled_from(['a', 'b', None]), st.sampled_from([1.0, 2.0]),
    st.one_of(st.none(), st.floats(-1e3, 1e3, allow_nan=False))),
    min_size=1, max_size=12))
def test_agg_statistics_bitwise(groups):
    """Grouped mean (Kahan) and sample std (Welford) equal pandas' to the
    bit, missing cells and keys included."""
    models = [{'job': i, 'set': s, 'beta': b, 'type': 'cvae',
               'accuracy_iws': v, 'accuracy': v}
              for i, (s, b, v) in enumerate(groups)]
    df = jtables.results_dataframe(models, index=['set', 'beta', 'job'])
    f = ttables.results_dataframe(models, index=['set', 'beta', 'job'])
    assert_frame_equal(ttables.agg_results(f), jtables.agg_results(df))
    assert_frame_equal(ttables.agg_results(f, group_by=['beta']),
                       jtables.agg_results(df, group_by=['beta']))


def test_export_losses_bytes(tmp_path):
    rng = np.random.default_rng(3)
    rec = {'total': rng.standard_normal((3, 11)).astype(np.float32),
           'kl': rng.standard_normal(11).astype(np.float32) * 1e5,
           'y_true': rng.integers(0, 3, 11)}
    jr, tr = JRecorder(4), LossRecorder(4)
    for s in range(0, 11, 4):
        batch = {k: v[..., s:s + 4] for k, v in rec.items()}
        jr.append_batch(**batch)
        tr.append_batch(**batch)
    a, b = str(tmp_path / 'j' / 'losses.tab'), str(tmp_path / 't' / 'l.tab')
    jdf = jtables.export_losses(jr, a)
    tdf = ttables.export_losses(tr, b)
    assert open(a, 'rb').read() == open(b, 'rb').read()
    assert tdf.columns == [(c,) for c in jdf.columns]
    assert len(tdf) == len(jdf) == 11


def test_textab_render_equal():
    """TexTab's own features: formats, faces, multicolumns, rules,
    separators and comments."""
    tabs = []
    for mod in (jtexify, ttexify):
        t = mod.TexTab('l', 'r', 'r', float_format='{:.2f}')
        t.append_cell('a_b', 'h', width=2, multicol_format='c|')
        t.append_cell(r'\acron{x}', 'h')
        t.append_cell(1.23456, 1, face='bf')
        t.append_cell(None, 1)
        t.append_cell(float('nan'), 1, formatter='{:.1f}')
        t.add_midrule('h', after=True)
        t.add_midrule(1, start=1, end=2)
        t.add_col_sep(2, '/')
        t.comment('jobs 1 2')
        tabs.append(t.render())
    assert tabs[0] == tabs[1]


def test_empty_fleet():
    assert ttables.results_dataframe([]).empty
    assert ttexify.texify_test_results_df(ttables.results_dataframe([])) == ''


@pytest.mark.parametrize('missing', ['beta', 'set'])
def test_duplicate_rows_with_missing_index_cells(tmp_path, missing):
    """A row listed twice (``--all-epochs``) with a missing index cell:
    pandas gives a missing float-level cell (beta) a fresh NaN, so the two
    rows get lines of their own, and a missing string-level cell (set) the
    shared ``np.nan``, so they share one; the port's files must match."""
    base = {'job': 1, 'type': 'cvae', 'set': 'mnist', 'arch_code': 'a1',
            'sigma_train': 'constant', 'beta': 1.0, 'gamma': 100.0,
            'latent_dim': 16, 'features': 'none', 'encoder': '512',
            'decoder': '512', 'upsampler': 'none', 'classifier': 'none',
            'prior': 'gaussian', 'depth': 2, 'width': 1024, 'sigma': 0.1,
            'latent_sampling': 1, 'optim': 'adam', 'lr': 1e-4,
            'batch_size': 128, 'done': 0, 'epochs': 10, 'finished': False}
    first = dict(base, **{missing: None})
    models = [first] + [dict(base, job=j) for j in (2, 3)] + [dict(first)]
    for sort in (False, True):
        df = jtables.results_dataframe(models, sort_index=sort)
        f = ttables.results_dataframe(models, sort_index=sort)
        assert_frame_equal(f, df)
        _write_both(f, df, str(tmp_path), 'dup', False)
