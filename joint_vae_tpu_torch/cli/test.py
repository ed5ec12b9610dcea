"""Fleet-evaluation CLI (ref test.py:19-523).

    python -m joint_vae_tpu_torch.cli.test --job-dir jobs [--dataset cifar10 ...]
        [--compute [hard]] [--latex --results-file name] [--device cpu]

Port of ``joint_vae_tpu/cli/test.py``, every flag but the JAX device
ones: ``--device`` picks the torch device of a recompute (the CUDA card
unless 'cpu' is asked for); ``--mesh``, ``--model-axis``,
``--sample-axis`` and ``--distributed`` run the recompute on a device
mesh (``torchrun --nproc-per-node N -m joint_vae_tpu_torch.cli.test ...
--mesh``; rank 0 writes the JSON files).  Runs that load no weights (no
``--compute``, the recorder tiers, ``--list-jobs-and-quit``,
``--dry-run``) load jobs as ghosts and touch no device; the recorder tier
replays on the host.

Flow: fetch+filter models -> plan via available_results (json / recorders /
compute per --compute mode) -> recompute what is missing -> build dataframes
-> print + optionally write .tex/.tab.

Filter flags: every key of the filter schema (utils/filters.py) is a CLI
flag, like the reference's create_filter_parser (utils/parameters.py:534+):
``--dataset cifar10 --type cvae --beta 1...10``.  ``--filter key=value``
remains as an explicit spelling.
"""

import argparse
import configparser
import logging
import os
import sys

from ..data.loaders import get_dataset
from ..save_load.dictify import available_results, make_dict_from_model
from ..save_load.fetch import fetch_models
from ..save_load.jobs import load_job, save_job
from ..evals.engines import (accuracy, ood_detection_rates,
                             misclassification_detection_rates)
from ..parallel.mesh import ensure_placed
from ..results.tables import results_dataframe, agg_results, auto_remove_index
from ..results.texify import texify_test_results_df
from ..utils.filters import (DictOfListsOfParamFilters, MetaFilter,
                             ParamFilter, filters_from_dict, get_filter_keys)
from ..utils.parameters import refuse_unported
from ..utils.testing import cache_early_stopping
from . import add_device_arg, add_mesh_args, mesh_from_args

# abbreviations from the reference's filters.ini [abbr] section
FILTER_ABBR = {'sigma': 's', 'latent_dim': 'K', 'latent_sampling': 'L',
               'test_latent_sampling': 'l', 'depth': 'D'}

# --compute mode -> result tiers the engines may use (ref test.py:110-121)
COMPUTE_TIERS = {
    False: ('json',),
    'recorder': ('json', 'recorders'),
    're': ('recorders',),
    'hard': ('json', 'recorders', 'compute'),
    'rehard': ('compute',),
}


def add_filter_args(p: argparse.ArgumentParser):
    """One CLI flag per filter-schema key (ref create_filter_parser)."""
    g = p.add_argument_group('filters')
    taken = {a for act in p._actions for a in act.option_strings}
    for key, spec in get_filter_keys().items():
        names = ['--' + key.replace('_', '-')]
        for a in spec.get('aliases', ()):
            if '/' not in a:
                names.append('--' + a.replace('_', '-'))
        if key in FILTER_ABBR:
            names.append('-' + FILTER_ABBR[key])
        names = [n for n in names if n not in taken]
        if not names:
            continue
        g.add_argument(*names, dest='flt_' + key, nargs='*', default=None,
                       metavar='V',
                       help='filter on {} (lists, "not", a...b)'.format(key))
    return g


def filters_from_args(args) -> DictOfListsOfParamFilters:
    d = {}
    for k, v in vars(args).items():
        if k.startswith('flt_') and v is not None:
            d[k[4:]] = ' '.join(str(_) for _ in v)
    for f in args.filter:
        k, _, v = f.partition('=')
        d[k] = v
    return filters_from_dict(d) if d else DictOfListsOfParamFilters()


def read_filter_file(path: str):
    """One filter INI -> (MetaFilter-or over sections, options dict)
    (ref parameters.py:500-530: sections are OR'd groups; [options] may
    carry '<set> ood = ...' lists and default ood/predict methods)."""
    cp = configparser.ConfigParser()
    # keep option-name case: schema aliases are case-sensitive (K/L vs k/l)
    cp.optionxform = str
    cp.read(path)
    options = {k.lower(): v for k, v in cp['options'].items()} \
        if 'options' in cp else {}
    keys = get_filter_keys()
    alias = {}
    for k, spec in keys.items():
        alias[k] = k
        for a in spec.get('aliases', ()):
            alias[a] = k
    groups = []
    for section in cp.sections():
        if section == 'options':
            continue
        flt = DictOfListsOfParamFilters()
        for k, v in cp[section].items():
            k_norm = k.replace('-', '_')
            kk = alias.get(k_norm, alias.get(k_norm.lower(), k_norm.lower()))
            t = keys.get(kk, {}).get('type', str)
            flt.add(kk, ParamFilter.from_string(v, type=t))
        groups.append(flt)
    return MetaFilter('or', *groups) if groups else None, options


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-test')
    p.add_argument('--job-dir', '-J', default='jobs')
    p.add_argument('--load-dir', default=None,
                   help='alternate directory searched for jobs '
                        '(outputs still relative to --job-dir; ref test.py)')
    p.add_argument('--filter', nargs='*', default=[],
                   help='key=value filter strings (value grammar: lists, '
                        'not, a...b intervals)')
    p.add_argument('--from-files', nargs='+', default=[],
                   help='filter INI files, OR-combined with each other and '
                        'AND-combined with CLI filters; an [options] section '
                        'may set "<set> ood", ood_methods, predict_methods '
                        '(ref parameters.py:500-530)')
    p.add_argument('--compute', nargs='?', const='recorder', default=False,
                   choices=['recorder', 're', 'hard', 'rehard'],
                   help='result tiers: absent=json only; bare '
                        '--compute=json+recorders; re=recorders only; '
                        'hard=json+recorders+model recompute; rehard='
                        'recompute only (ref test.py:110-121)')
    p.add_argument('--register', dest='flash', action='store_false',
                   help='rebuild the model registry cache (ref --register)')
    p.add_argument('--epoch', default='last')
    p.add_argument('--epoch-tolerance', type=int, default=5)
    p.add_argument('--all-epochs', action='store_true',
                   help='one row per available result epoch per job '
                        '(ref test.py:171)')
    p.add_argument('--early-stopping', nargs='?', const='min-loss',
                   default=None, metavar='STRATEGY-WHICH',
                   help="pick each job's early-stopping epoch, e.g. "
                        "min-loss (ref test.py --early-stopping)")
    p.add_argument('--batch-size', '-M', type=int, default=512)
    p.add_argument('--test-sample-size', '-t', type=int, default=0,
                   help='cap recomputation to this many samples '
                        '(0 = whole set; ref test.py -t)')
    p.add_argument('--min-test-sample-size', '-T', type=int, default=0,
                   help='(parsed but unused in the reference, test.py:45)')
    p.add_argument('--ood', '-o', type=int, nargs='?', const=-1, default=0,
                   help='(parsed but unused in the reference, test.py:44)')
    p.add_argument('--cautious', action='store_true')
    p.add_argument('--sets', action='append', nargs='+', default=[],
                   metavar='SET',
                   help='per-testset OOD restriction: --sets TESTSET OOD... '
                        '(ref test.py:53-64); a single group naming no '
                        "job's trainset is used as a flat OOD list")
    p.add_argument('--ood-methods', nargs='*', default=None,
                   help='restrict OOD scoring methods (ref test.py)')
    p.add_argument('--predict-methods', nargs='*', default=None,
                   help='restrict accuracy predict methods (ref test.py)')
    p.add_argument('--misclass-methods', nargs='*', default=None,
                   help='restrict misclassification methods (ref test.py)')
    p.add_argument('--classification-methods', nargs='+', default=None,
                   help='(parsed but unused in the reference, test.py)')
    p.add_argument('--only-finished', '-F', action='store_true',
                   help='keep only jobs trained to their target epochs '
                        '(ref test.py -F)')
    p.add_argument('--tpr', type=int, nargs='*', default=[95],
                   help='kept-TPR level(s); the first is the FPR column '
                        'shown (ref test.py --tpr)')
    p.add_argument('--tnr', action='store_true',
                   help='show TNR (1-FPR) instead of FPR (ref test.py --tnr)')
    p.add_argument('--list-jobs-and-quit', action='store_true')
    p.add_argument('--expand', '-x', action='count', default=1,
                   help='given twice, one column per (set, method) instead '
                        'of the best method (ref test.py:326)')
    p.add_argument('-e', dest='show_measures', action='count', default=0,
                   help='each -e reveals more columns (train params, n, '
                        'measures; ref test.py -e)')
    p.add_argument('--agg', '--show-average', dest='agg', action='store_true',
                   help='print the mean/std aggregation too')
    p.add_argument('--only-average', action='store_true',
                   help='print only the aggregated table (ref test.py)')
    p.add_argument('--remove-index', nargs='*', default=['auto'],
                   help="index levels to drop; 'auto' drops constant ones "
                        '(ref test.py --remove-index)')
    p.add_argument('--tex', default=None)
    p.add_argument('--tab', default=None)
    p.add_argument('--results-file', default=None,
                   help='basename for .tab/.tex outputs under '
                        '--results-directory (ref test.py)')
    p.add_argument('--results-directory', default='results',
                   help='where --results-file/--latex outputs go')
    p.add_argument('--latex', action='store_true',
                   help='also write a .tex next to the .tab (ref test.py)')
    p.add_argument('--best', action='store_true',
                   help='bold the best value per metric column in the .tex '
                        '(max accuracy/auc, min fpr)')
    p.add_argument('--last', type=int, nargs='?', const=10, default=0,
                   help='keep only the N highest job numbers (ref test.py)')
    p.add_argument('--sort', nargs='*', default=[],
                   help='sort rows by these flat-dict keys; a trailing "-" '
                        'sorts descending; "print" lists possible keys '
                        '(ref test.py --sort)')
    p.add_argument('--job-id', type=int, default=0,
                   help='suffix for the test-<id>.out log file (ref test.py)')
    p.add_argument('--dry-run', action='store_true',
                   help='plan and print, do not recompute or save')
    p.add_argument('--export-losses', action='store_true',
                   help='write per-job recorded losses as losses-<set>.tab '
                        '(ref utils/tables.py:26-83)')
    p.add_argument('-v', '--verbose', action='count', default=0)
    p.add_argument('--debug', action='store_true')
    add_device_arg(p)
    add_mesh_args(p)
    add_filter_args(p)
    args = p.parse_args(argv)
    refuse_unported(args)
    mesh = mesh_from_args(args)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)

    if args.cautious:
        # the reference's own stub (test.py:135)
        logging.warning('Cautious verifications to be implemented')
    for flag, v in (('--min-test-sample-size', args.min_test_sample_size),
                    ('--ood', args.ood),
                    ('--classification-methods', args.classification_methods)):
        if v:
            logging.warning('%s is accepted but (like the reference) unused',
                            flag)

    print_sorting_keys = False
    if 'print' in args.sort:
        args.sort.remove('print')
        print_sorting_keys = True

    flt = filters_from_args(args)
    oodsets = {}
    for group in args.sets:
        oodsets[group[0]] = list(group[1:])
    file_filter = None
    for f in args.from_files:
        ff, options = read_filter_file(f)
        if ff is not None:
            file_filter = (ff if file_filter is None
                           else MetaFilter('or', file_filter, ff))
        for k, v in options.items():
            if k.split()[-1] == 'ood':
                indist = k.split()[0]
                oodsets.setdefault(indist, v.split())
            elif k == 'ood_methods' and args.ood_methods is None:
                args.ood_methods = v.split()
            elif k == 'predict_methods' and args.predict_methods is None:
                args.predict_methods = v.split()
    if file_filter is not None:
        flt = MetaFilter('and', flt, file_filter)

    search_dir = args.load_dir or args.job_dir
    models = fetch_models(search_dir, filter=flt, flash=args.flash)
    # the reference drops resumed and derailed jobs (test.py:130-145)
    models = [m for m in models
              if not m.get('is_resumed') and not m.get('derailed')]
    if args.only_finished:
        models = [m for m in models if m.get('finished')]
    if args.list_jobs_and_quit:
        for m in sorted(models, key=lambda m: m.get('job') or 0):
            print(m.get('job'), m.get('dir'))
        return 0
    if args.last:
        models = sorted(models, key=lambda m: m.get('job') or 0)[-args.last:]
    if args.sort:
        for key in reversed(args.sort):
            rev = key.endswith('-')
            k = key.rstrip('-')
            models = sorted(models,
                            key=lambda m: (m.get(k) is None, m.get(k)),
                            reverse=rev)
    logging.info('%d models', len(models))

    where = COMPUTE_TIERS[args.compute]
    need_engines = args.compute and not args.dry_run
    # only a recompute loads weights; every other run loads ghosts
    load_state = 'compute' in where and bool(need_engines)
    # an explicit --epoch bounds result selection by --epoch-tolerance;
    # 'last' keeps the nearest-epoch default
    ep_tol = args.epoch_tolerance if args.epoch != 'last' else None
    if args.epoch not in ('last', 'min-loss'):
        args.epoch = int(args.epoch)
    es = (tuple(args.early_stopping.split('-'))
          if args.early_stopping else None)

    # a group whose head is no kept job's trainset is the legacy flat form
    trainsets = {m.get('set') for m in models}
    if len(oodsets) == 1 and not (set(oodsets) & trainsets):
        head = next(iter(oodsets))
        flat = [head] + oodsets[head]
        oodsets = {s: flat for s in trainsets}

    # bare --tpr (nargs='*') is legal: degrade to the default level
    tpr0 = args.tpr[0] if args.tpr else 95

    refreshed = []
    # --sets restrictions must route through make_dict_from_model, so they
    # also force the reload path (ref test.py:193-198)
    nondefault_view = (args.epoch != 'last' or tpr0 != 95 or bool(oodsets))
    for m in models:
        wanted_epochs = [args.epoch]
        if (args.all_epochs or need_engines or args.early_stopping
                or nondefault_view):
            try:
                job = (load_job(m['dir'], device=args.device) if load_state
                       else load_job(m['dir'], ghost=True))
            except Exception as e:
                logging.warning('cannot load %s: %s', m['dir'], e)
                refreshed.append(m)
                continue
            if args.early_stopping:
                which = es[-1] if len(es) > 1 else 'loss'
                ep = cache_early_stopping(
                    job, metric={'loss': 'total'}.get(which, which))
                if ep is not None:
                    wanted_epochs = [ep]
            if args.all_epochs:
                wanted_epochs = sorted(available_results(
                    job, epoch_tolerance=int(1e9))) or [args.epoch]
        else:
            refreshed.append(m)
            continue

        name = job.training_parameters.get('set')
        # display restriction for make_dict_from_model: None = no restriction
        # (the reference passes oodsets_n=None when --sets is absent)
        ood_names = oodsets.get(name)
        if need_engines:
            # per-method recompute: the engines resolve each (set, method)
            # from the json / recorders / compute tiers and only evaluate
            # the residue (ref available_results, dictify.py:215-382 +
            # test.py:178-318)
            _, testset = get_dataset(name, splits=['test'])
            # the engine set list defaults to same-size companions without
            # becoming a display restriction
            engine_ood = (ood_names if ood_names is not None
                          else testset.same_size)
            sets = []
            for n in engine_ood:
                try:
                    _, s = get_dataset(n, splits=['test'])
                    sets.append(s)
                except Exception:
                    pass
            num_batch = (-(-args.test_sample_size // args.batch_size)
                         if args.test_sample_size else None)
            # a flag given with zero values ('--predict-methods') means NONE
            # (skip that pass), like --sets; only an absent flag means 'all'
            pm = 'all' if args.predict_methods is None else args.predict_methods
            om = 'all' if args.ood_methods is None else args.ood_methods
            mm = ('all' if args.misclass_methods is None
                  else args.misclass_methods)
            if mesh is not None and job.state is not None:
                job.state = ensure_placed(job.state, mesh)
            for ep in wanted_epochs:
                accuracy(job, testset, batch_size=args.batch_size,
                         num_batch=num_batch, method=pm, epoch=ep,
                         from_where=where, mesh=mesh)
                ood_detection_rates(job, testset, sets,
                                    batch_size=args.batch_size,
                                    num_batch=num_batch, mesh=mesh,
                                    method=om, epoch=ep, from_where=where)
                misclassification_detection_rates(
                    job, testset, batch_size=args.batch_size,
                    num_batch=num_batch, predict_methods=pm,
                    misclass_methods=mm, epoch=ep, from_where=where,
                    mesh=mesh)
            save_job(job, m['dir'], save_state=False)
        for ep in wanted_epochs:
            refreshed.append(make_dict_from_model(
                job, directory=m['dir'], wanted_epoch=ep,
                epoch_tolerance=ep_tol, oodsets=ood_names,
                tpr=tpr0 / 100))

    if args.export_losses:
        from ..save_load.recorders import LossRecorder
        from ..results.tables import export_losses
        for m in refreshed:
            d = m.get('dir')
            samples = os.path.join(d or '', 'samples')
            if not d or not os.path.isdir(samples):
                continue
            epochs = sorted(e for e in os.listdir(samples) if e.isdigit())
            if not epochs:
                continue
            for name, rec in LossRecorder.loadall(
                    os.path.join(samples, epochs[-1])).items():
                export_losses(rec, os.path.join(d, 'losses-{}.tab'.format(name)))
                logging.info('losses-%s.tab written for job %s', name,
                             m.get('job'))

    all_methods = 'all' if args.expand > 1 else 'first'
    df = results_dataframe(
        refreshed, tpr=tpr0, tnr=args.tnr, sort_index=not args.sort,
        ood_methods=args.ood_methods or all_methods,
        predict_methods=args.predict_methods or all_methods,
        measures=args.show_measures >= 2)
    if df.empty:
        print('no models')
        return 0

    # --remove-index: 'auto' drops constant levels; named levels drop
    # explicitly (ref test.py:384-417)
    removable = list(args.remove_index)
    if 'auto' in removable:
        removable.remove('auto')
        df = auto_remove_index(df, keep=['job', 'type'])
    unremoved = []
    for n in removable:
        nn = n.replace('-', '_')
        if nn in df.index_names and df.nlevels > 1:
            df = df.droplevel(nn)
        else:
            unremoved.append(n)
    if unremoved:
        logging.error('%s are not removed. Possible removable index: %s',
                      ', '.join(unremoved), ', '.join(map(str, df.index_names)))

    # -e column pruning (ref test.py:458-470 col_show_levels)
    levels = {}
    for c in df.columns:
        g = c[0]
        if g in ('accuracy', 'auc') or g.startswith(('fpr', 'tnr')):
            levels[c] = 0
        elif g == 'measures':
            levels[c] = 2
        elif g == 'train':
            levels[c] = 3 if c[-1] in ('done', 'epochs', 'finished') else 1
        else:                       # arch detail
            levels[c] = 4
    drop_cols = [c for c in df.columns if levels[c] > args.show_measures]
    shown = df.drop_columns(drop_cols) if drop_cols else df

    with_all = shown
    agg = None
    if args.agg or args.only_average:
        agg = agg_results(shown)
    if args.only_average and agg is not None:
        with_all = agg
    print(with_all.to_string())
    if args.agg and not args.only_average and agg is not None:
        width = len(str(agg).split('\n')[0]) if len(agg) else 20
        print('{:-^{w}}'.format('AVERAGE', w=width))
        print(agg.to_string())
    if print_sorting_keys:
        print('Possible sorting keys :', *df.index_names)

    tex, tab = args.tex, args.tab
    if args.results_file:
        os.makedirs(args.results_directory, exist_ok=True)
        base = os.path.join(args.results_directory, args.results_file)
        tab = tab or base + '.tab'
        if args.latex:
            tex = tex or base + '.tex'
    if tex or tab:
        # saved tables keep all columns: the -e pruning is console-display
        # only (ref test.py texifies the full frame at :390 before the
        # display pruning at :468)
        texify_test_results_df(df, tex_file=tex, tab_file=tab,
                               best_in_group=args.best)
        if agg is not None and args.results_file:
            # saved aggregates follow the saved main table: aggregate the
            # FULL frame, not the -e display-pruned one (round-3 advisor)
            texify_test_results_df(
                agg_results(df),
                tex_file=(base + '-agg.tex' if args.latex else None),
                tab_file=base + '-agg.tab', best_in_group=False)
    return 0


if __name__ == '__main__':
    sys.exit(main())
