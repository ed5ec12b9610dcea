"""Result tables: flat model dicts -> tables with named index levels.

The port's copy of ``joint_vae_tpu/results/tables.py`` on its own table
type (``frame.py``) instead of pandas: the same rows, columns, order and
aggregates, and the same bytes in the files written from them.

Re-design of ref ``utils/tables.py``:

- :func:`results_dataframe` (ref :84-350): one row per job, columns grouped
  into (arch | train | accuracy | per-OOD-set AUC/FPR) with a MultiIndex;
- :func:`agg_results` (ref :366-430): groupby over architecture keys with
  mean/std aggregation and job counts;
- :func:`export_losses` (ref :26-83): per-job recorded losses -> .tab file;
- :func:`auto_remove_index`: drop constant index levels (ref :352-364).
"""

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .frame import Frame

DEFAULT_INDEX = ['type', 'set', 'arch_code', 'sigma_train', 'beta', 'gamma',
                 'latent_dim', 'job']

ARCH_COLUMNS = ['features', 'encoder', 'latent_dim', 'decoder', 'upsampler',
                'classifier', 'prior', 'depth', 'width']
TRAIN_COLUMNS = ['beta', 'gamma', 'sigma', 'latent_sampling', 'optim', 'lr',
                 'batch_size', 'done', 'epochs', 'finished']


MEASURE_KEYS = ['mse', 'rmse', 'dB', 'kl', 'test_loss', 'sigma', 'zdist',
                'iws', 'validation_loss']


def results_dataframe(models: List[Dict], index: Optional[Sequence[str]] = None,
                      ood: bool = True, tpr: int = 95, tnr: bool = False,
                      sort_index: bool = True,
                      ood_methods='first', predict_methods='all',
                      measures: bool = False) -> Frame:
    """Rows = jobs; columns = (group, key) MultiIndex.

    ``tpr`` selects which kept-TPR level's FPR column appears (the
    reference's per-table tpr option, results/__main__.py); ``tnr`` shows
    1-FPR under a 'tnr' group instead (ref test.py --tnr);
    ``sort_index=False`` keeps the caller's model order (--sort/--last).

    ``ood_methods``/``predict_methods`` control method expansion (ref
    test.py:326 ``all_methods = 'all' if args.expand > 1 else 'first'``):
    'first' keeps one column per OOD set (the best method) / the best
    accuracy; 'all' adds one column per (set, method); a list restricts to
    those methods.  ``measures=True`` adds a 'measures' column group from
    the history-derived metric keys (ref test.py show_measures)."""
    if not models:
        return Frame([], [], [], [])
    index = list(index or DEFAULT_INDEX)
    rows = []
    for m in models:
        row = {}
        for k in index:
            row[('index', k)] = m.get(k)
        for k in ARCH_COLUMNS:
            row[('arch', k)] = m.get(k)
        for k in TRAIN_COLUMNS:
            row[('train', k)] = m.get(k)
        for k, v in m.items():
            if k == 'accuracy':
                row[('accuracy', 'best')] = v
            elif k == 'accuracy_epoch':
                # an epoch number, not an accuracy — keep it out of the
                # metric group so agg_results never averages epochs
                row[('train', 'acc_epoch')] = v
            elif k.startswith('accuracy_'):
                pm = k[len('accuracy_'):]
                if predict_methods == 'all' or (
                        not isinstance(predict_methods, str)
                        and pm in predict_methods):
                    row[('accuracy', pm)] = v
        if measures:
            for k in MEASURE_KEYS:
                if m.get(k) is not None:
                    row[('measures', k)] = m[k]
        if ood:
            fpr_suffix = '_fpr{}'.format(tpr)
            # per-set best-method summary columns (always present)
            for k, v in m.items():
                if not k.startswith('ood_'):
                    continue
                body = k[4:]
                if k.endswith('_auc'):
                    body = body[:-4]
                elif k.endswith(fpr_suffix):
                    body = body[:-len(fpr_suffix)]
                else:
                    continue
                # 'ood_<set>_auc' (best) has no method part; method grids
                # are 'ood_<set>_<m>_auc' — distinguish via the known sets
                sets_with_best = {kk[4:-7] for kk in m
                                  if kk.startswith('ood_')
                                  and kk.endswith('_method')}
                if body in sets_with_best or '_' not in body:
                    col = body
                elif ood_methods == 'first' or (
                        isinstance(ood_methods, str) and ood_methods != 'all'):
                    continue
                else:
                    s, _, meth = body.rpartition('_')
                    while s and s not in sets_with_best and '_' in s:
                        s2, _, m2 = s.rpartition('_')
                        meth = '{}_{}'.format(m2, meth)
                        s = s2
                    if ood_methods != 'all' and meth not in ood_methods:
                        continue
                    col = '{}/{}'.format(s, meth)
                if k.endswith('_auc'):
                    row[('auc', col)] = v
                elif tnr:
                    row[('tnr{}'.format(tpr), col)] = (
                        1.0 - v if v is not None else None)
                else:
                    row[('fpr{}'.format(tpr), col)] = v
        rows.append(row)
    df = Frame.from_records(rows, index=[('index', k) for k in index])
    return df.sort_index() if sort_index else df


def auto_remove_index(df: Frame, keep: Sequence[str] = ('job',)) -> Frame:
    """Drop index levels with a single unique value (ref tables.py:352-364)."""
    to_drop = [n for n in df.index_names
               if n not in keep and df.nunique(n) <= 1]
    if len(to_drop) == len(df.index_names):
        to_drop = to_drop[:-1]
    return df.droplevel(to_drop) if to_drop else df


def agg_results(df: Frame, group_by: Optional[Sequence[str]] = None,
                metrics_groups: Sequence[str] = ('accuracy', 'auc')
                ) -> Frame:
    """mean/std/count per architecture group (ref tables.py:366-430).

    Any ``fpr<NN>``/``tnr<NN>`` column group counts as a metric regardless
    of the table's selected TPR level (tnr=True tables must not lose their
    OOD columns in aggregation)."""
    if df.empty:
        return df
    group_by = [n for n in (group_by or [n for n in df.index_names
                                         if n != 'job'])
                if n in df.index_names]
    metric_cols = [c for c in df.columns
                   if c[0] in metrics_groups
                   or c[0].startswith(('fpr', 'tnr'))]
    if not metric_cols or not group_by:
        return df
    return df.select(metric_cols).agg(group_by)


def export_losses(recorder, path: str, keys: Optional[Sequence[str]] = None):
    """Recorded per-item losses -> whitespace .tab file (ref tables.py:26-83)."""
    keys = list(keys or recorder.keys())
    cols = {}
    for k in keys:
        v = recorder.get(k)
        if v.ndim == 1:
            cols[k] = v
        else:
            for c in range(v.shape[0]):
                cols['{}_{}'.format(k, c)] = v[c]
    kinds = {'f': 'float', 'i': 'int', 'u': 'int', 'b': 'bool'}
    n = len(next(iter(cols.values()))) if cols else 0
    df = Frame([], [()] * n, [(k,) for k in cols],
               [list(r) for r in zip(*(c.tolist() for c in cols.values()))],
               kinds=[kinds.get(np.asarray(c).dtype.kind, 'object')
                      for c in cols.values()])
    df.to_csv(path, sep=' ', index=False, float_format='%.6g')
    return df
