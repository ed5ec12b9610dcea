"""INI-driven paper tables (ref results/__main__.py:32-400).

    python -m joint_vae_tpu_torch.cli.results <config.ini> [--job-dir jobs]

Port of ``joint_vae_tpu/cli/results.py`` on the port's table type
(``results/frame.py``): the same .tex and .tab files.  It reads the
registry and ghost loads only, and touches no device.

Two table modes:

**Comparison mode** (the reference's main pipeline) — when the INI's
``[DEFAULT]`` carries ``dataset`` and ``ood``, the whole file builds ONE
table: each non-default section is a model group (a column pair), rows are
the accuracy row plus one row per OOD set (plus optional ``average`` rows),
and the cell grid is (fpr@tpr | auc) x sections with best-in-row bolding:

    [DEFAULT]
    dataset = cifar10
    ood = svhn lsunr const32
    tpr = 95
    ood_method = iws-a-4-1
    acc_method = iws
    average = average svhn lsunr
    kept_index = sigma_train

    [g-vae]
    type = vae
    prior_distribution = gaussian

**Per-section mode** (legacy) — without ``dataset``+``ood`` each section is
an independent job-table (filters + ``tpr``/``agg``/``best`` options) written
to ``<section>.tex``/``.tab``.
"""

import argparse
import configparser
import logging
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from ..results.tables import results_dataframe, agg_results, auto_remove_index
from ..results.texify import TexTab, texify_test_results_df
from ..save_load.dictify import make_dict_from_model
from ..save_load.fetch import fetch_models
from ..save_load.jobs import load_job
from ..utils.filters import filters_from_dict

TABLE_OPTIONS = {'tpr', 'agg', 'index', 'out', 'best',
                 'dataset', 'ood', 'ood_method', 'acc_method', 'average',
                 'kept_index', 'file', 'epoch'}


def _section_models(models, opts) -> List[Dict]:
    filter_keys = {k: v for k, v in opts.items() if k not in TABLE_OPTIONS}
    flt = filters_from_dict(filter_keys)
    group = [m for m in models if flt(m) and not m.get('derailed')]
    epoch = opts.get('epoch')
    if epoch and epoch != 'last':
        # per-section epoch selection ('min-loss' = the cached
        # early-stopping epoch, or an int; ref results/__main__.py:113-119)
        wanted = epoch if epoch == 'min-loss' else int(epoch)
        rebuilt = []
        for m in group:
            try:
                job = load_job(m['dir'], ghost=True)
                rebuilt.append(make_dict_from_model(job, m['dir'],
                                                    wanted_epoch=wanted))
            except Exception:
                rebuilt.append(m)
        group = rebuilt
    return group


def _cell(m: Dict, set_name: str, metric: str, method: str, tt: int,
          dataset: str) -> Optional[float]:
    """One model's value for a (row set, metric) cell; method-specific keys
    first (ood_{s}_{m}_auc), best-method fallback (ood_{s}_auc)."""
    if set_name == 'acc':
        if metric == 'auc':
            return None
        if method and 'accuracy_{}'.format(method) in m:
            return m['accuracy_{}'.format(method)]
        return m.get('accuracy')
    suffix = 'auc' if metric == 'auc' else 'fpr{}'.format(tt)
    if method:
        # an explicitly requested method never falls back to the
        # best-method columns — a missing value renders as '--' rather
        # than silently showing another method's numbers
        return m.get('ood_{}_{}_{}'.format(set_name, method, suffix))
    return m.get('ood_{}_{}'.format(set_name, suffix))


def comparison_table(cp: configparser.ConfigParser, models: List[Dict],
                     out_dir: str, name: str) -> Optional[str]:
    """The reference's one-table-per-INI pipeline
    (results/__main__.py:238-400)."""
    dflt = cp.defaults()
    dataset = dflt['dataset']
    oods = dflt['ood'].split()
    tt = int(dflt.get('tpr', 95))
    kept_index = [k.split(':')[0] for k in dflt.get('kept_index', '').split()]
    kept_fmts = [(k.split(':') + ['c'])[1]
                 for k in dflt.get('kept_index', '').split()]
    average = dflt.get('average', '').split()
    avg_name, avg_over = None, []
    if average:
        avg_name = average[0]
        avg_over = average[1:] or list(oods)

    sections = cp.sections()
    per: Dict[str, Dict] = {}       # section -> {(kept, set, metric): [v..]}
    jobs: Dict[str, List] = {}
    for k in sections:
        opts = dict(cp[k])
        group = _section_models(models, opts)
        jobs[k] = sorted(m.get('job') for m in group)
        acc_m = opts.get('acc_method', '')
        ood_m = opts.get('ood_method', '')
        cells: Dict = {}
        for m in group:
            if m.get('set') not in (dataset, None):
                continue
            kept = tuple(m.get(i) for i in kept_index)
            for s in ['acc'] + oods:
                for metric in ('rate', 'auc'):
                    v = _cell(m, s, metric, acc_m if s == 'acc' else ood_m,
                              tt, dataset)
                    if v is not None:
                        cells.setdefault((kept, s, metric), []).append(v)
        per[k] = {key: float(np.mean(vs)) for key, vs in cells.items()}

    kept_tuples = sorted({key[0] for k in sections for key in per[k]},
                         key=str)
    if not kept_tuples:
        print('[{}] comparison table: no matching models'.format(name))
        return None

    row_sets = ['acc'] + list(oods)
    if avg_name:
        present = [s for s in avg_over if s in row_sets]
        if present:
            row_sets.insert(max(row_sets.index(s) for s in present) + 1,
                            avg_name)
        else:
            avg_name = None

    n = len(sections)
    col_fmt = ['l'] * (1 + len(kept_index))
    for i, f in enumerate(kept_fmts):
        col_fmt[1 + i] = f if f in ('l', 'c', 'r') else 'c'
    col_fmt += ['r'] * (2 * n)
    tab = TexTab(*col_fmt, float_format='{:2.1f}', na_rep='--')

    # meta header (fpr@tpr | auc spans) + methods header
    for _ in range(1 + len(kept_index)):
        tab.append_cell('', 'meta_header')
    tab.append_cell(r'\acron{fpr}@%d' % tt, 'meta_header', width=n)
    tab.append_cell(r'\acron{auc}', 'meta_header', width=n)
    tab.append_cell('', 'header')
    for i, ki in enumerate(kept_index):
        tab.append_cell(ki, 'header')
    for _ in range(2):
        for k in sections:
            tab.append_cell(k, 'header')
    tab.add_midrule('header', after=True)

    # best values per row for the bolding pass
    rows = []
    for kept in kept_tuples:
        for s in row_sets:
            rows.append((kept, s))

    values: Dict = {}
    for kept, s in rows:
        for metric in ('rate', 'auc'):
            for k in sections:
                if s == avg_name:
                    vs = [per[k].get((kept, o, metric)) for o in avg_over]
                    vs = [v for v in vs if v is not None]
                    v = float(np.mean(vs)) if vs else None
                else:
                    v = per[k].get((kept, s, metric))
                values[(kept, s, metric, k)] = v

    last_acc_row = None
    for kept, s in rows:
        key = (kept, s)
        tab.append_cell(s, key)
        for i, kv in enumerate(kept):
            tab.append_cell(kv, key)
        rates = [values[(kept, s, 'rate', k)] for k in sections]
        aucs = [values[(kept, s, 'auc', k)] for k in sections]
        rs = [v for v in rates if v is not None]
        as_ = [v for v in aucs if v is not None]
        # acc row: best = max rate; ood rows: best = min fpr / max auc
        best_rate = (max(rs) if s == 'acc' else min(rs)) if rs else None
        best_auc = max(as_) if as_ else None
        for vals, best in ((rates, best_rate), (aucs, best_auc)):
            for v in vals:
                face = ('bf' if v is not None and best is not None
                        and abs(100 * v - 100 * best) < 0.05 else None)
                tab.append_cell(None if v is None else 100 * v, key,
                                face=face)
        if s == 'acc':
            last_acc_row = key
        if s == avg_name:
            tab.add_midrule(key, after=False, start=1 + len(kept_index))
    if last_acc_row is not None:
        tab.add_midrule(last_acc_row, after=True)

    for k in sections:
        tab.comment('{:=^70}'.format(' ' + k + ' '))
        tab.comment('{} models: {}'.format(
            len(jobs[k]), ' '.join(str(j) for j in jobs[k])))

    fname = dflt.get('file') or '{}-tab'.format(name)
    tex = os.path.join(out_dir, fname + '.tex')
    tab.save(tex)

    # .tab companion: flat csv of the same grid
    import csv
    with open(os.path.join(out_dir, fname + '.tab'), 'w', newline='') as f:
        w = csv.writer(f, delimiter=' ')
        w.writerow(['set'] + kept_index
                   + ['{}-rate'.format(k) for k in sections]
                   + ['{}-auc'.format(k) for k in sections])
        for kept, s in rows:
            w.writerow([s] + [str(v) for v in kept]
                       + ['{:.1f}'.format(100 * values[(kept, s, m, k)])
                          if values[(kept, s, m, k)] is not None else 'nan'
                          for m in ('rate', 'auc') for k in sections])
    print('[{}] comparison table ({} sections) -> {}'.format(
        name, len(sections), tex))
    return tex


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-results')
    p.add_argument('configs', nargs='+', metavar='config',
                   help='results INI file(s) (ref results/__main__.py:437)')
    p.add_argument('--job-dir', default='jobs')
    p.add_argument('--out-dir', '--result-dir', default=None)
    p.add_argument('--which', '-c', nargs='*', default=['all'],
                   help='restrict to these INI sections (ref --which)')
    p.add_argument('--tpr', type=int, default=None,
                   help='default kept-TPR percent for sections without a '
                        'tpr option (ref results/__main__.py:434)')
    p.add_argument('--register', dest='flash', action='store_false',
                   help='rebuild the model registry cache (ref --register)')
    p.add_argument('-q', action='store_false', dest='show_dfs',
                   help='quiet: write files only (ref results/__main__.py)')
    p.add_argument('--texify', default=None,
                   help='(accepted for reference compatibility; table '
                        'styling is built in here)')
    p.add_argument('--filters-file', default=None,
                   help='(accepted for reference compatibility; the filter-'
                        'key schema is built in here)')
    p.add_argument('--auc', action='store_true',
                   help='(accepted for reference compatibility; auc columns '
                        'are always included)')
    p.add_argument('-v', '--verbose', action='count', default=0)
    p.add_argument('--debug', action='store_true')
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)
    if args.texify or args.filters_file:
        logging.warning('--texify/--filters-file are accepted for reference '
                        'compatibility but the schemas are built in')

    rc = 0
    for config in args.configs:
        if _one_config(config, args) != 0:
            rc = 1
    return rc


def _one_config(config, args):
    cp = configparser.ConfigParser()
    cp.read(config)
    out_dir = args.out_dir or os.path.dirname(os.path.abspath(config))
    name = os.path.splitext(os.path.basename(config))[0]

    models = fetch_models(args.job_dir, flash=args.flash)

    if cp.defaults().get('dataset') and cp.defaults().get('ood'):
        tex = comparison_table(cp, models, out_dir, name)
        return 0 if tex else 1

    sections = cp.sections()
    if 'all' not in args.which:
        sections = [s for s in sections if s in args.which]

    wrote = []
    for section in sections:
        opts = dict(cp[section])
        group = _section_models(models, opts)
        if not group:
            print('[{}] no models'.format(section))
            continue
        try:
            tpr = int(opts.get('tpr', args.tpr if args.tpr is not None
                      else 95))
        except ValueError:
            print('[{}] bad tpr option {!r} (want an integer percent)'
                  .format(section, opts['tpr']))
            continue
        df = auto_remove_index(results_dataframe(group, tpr=tpr))
        if opts.get('agg', '').lower() == 'true':
            df = agg_results(df)
        if args.show_dfs:
            print(df.to_string())
        tex = os.path.join(out_dir, '{}.tex'.format(section))
        tab = os.path.join(out_dir, '{}.tab'.format(section))
        texify_test_results_df(
            df, tex_file=tex, tab_file=tab,
            best_in_group=opts.get('best', '').lower() == 'true')
        wrote.append(tex)
        print('[{}] {} models -> {}'.format(section, len(group), tex))
    return 0 if wrote else 1


if __name__ == '__main__':
    sys.exit(main())
