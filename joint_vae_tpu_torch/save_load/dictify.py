"""Flat model-summary dicts + the 3-tier available-results planner.

The port's own copy of ``joint_vae_tpu/save_load/dictify.py``: for the
same job directory both packages build the same dict, key for key and
value for value, so that the registry file (``fetch.py``) serves either.

- :func:`make_dict_from_model` (ref utils/save_load/dictify.py:474-876):
  one flat dict per job with architecture / training / results keys — the
  rows of the fleet-query dataframes and the operands of ParamFilters.
- :func:`available_results` (ref dictify.py:215-382): for a wanted epoch
  (with tolerance) and method sets, what is available from three tiers —
  'json' (stored results), 'recorders' (recorded loss tensors, checked
  against :func:`needed_components`), 'compute' (re-run the model).
"""

import os
import zlib
from typing import Any, Dict, List, Optional, Sequence

from ..models.cvnet import METHODS_PARAMS
from ..ops.scores import develop_starred_methods, strip_roc_suffix
from .jobs import Job
from .recorders import LossRecorder

# bumped whenever make_dict_from_model's key schema changes — the registry
# cache (fetch.py) rebuilds entries written under an older schema
DICT_SCHEMA_VERSION = 3


def needed_components(method: str) -> List[str]:
    """Which recorded loss keys a method needs (ref dictify.py:434-471)."""
    m = strip_roc_suffix(method)
    if m and m[-1] in '~@':
        # WIM variants (ref dictify.py:453-461): '~' scores at the
        # estimated label (needs y_est_already), '@' needs the
        # alternate-prior twin, '~@' needs both
        base = m.rstrip('~@')
        base = base[4:] if base.startswith('soft') else base
        key = 'total' if base == 'elbo' else base
        if m.endswith('~@'):
            return [key, key + '@', 'y_est_already']
        if m.endswith('@'):
            # scoring aggregates the in-prior loss before subtracting the
            # twin (ft/wim.py::wim_measures), so both are needed (the
            # reference's table lists only the twin, dictify.py:457)
            return [key, key + '@']
        return [key, 'y_est_already']
    if m.startswith('odin'):
        return [m, 'logits']
    if m in ('baseline', 'logits', 'hyz') or m.startswith('baseline'):
        return ['logits']
    if m == 'elbo' or m in ('sum', 'max', 'mean', 'std', 'mag', 'nstd', 'IYx'):
        return ['total']
    if m == 'iws' or m.startswith('softiws'):
        return ['iws']
    if m in ('soft', 'softkl') or m.startswith('softkl'):
        return ['kl']
    if m.startswith('softzdist'):
        return ['zdist']
    if m == 'mse':
        return ['cross_x']
    if m == 'wmse':
        return ['wmse']
    if m in ('kl', 'zdist', 'total', 'cross_x', 'cross_y', 'var_kl'):
        return [m]
    # predict methods
    if m == 'esty':
        return ['logits']
    if m == 'loss':
        return ['total']
    if m == 'closest':
        return ['zdist']
    if m == 'already':
        return ['y_est_already']
    return [m]


def available_results(job: Job,
                      testset: Optional[str] = None,
                      oodsets: Optional[Sequence[str]] = None,
                      predict_methods='all',
                      ood_methods='all',
                      misclass_methods='all',
                      wanted_epoch='last',
                      epoch_tolerance: int = 5,
                      where: Sequence[str] = ('json', 'recorders', 'compute'),
                      ) -> Dict[int, Dict[str, dict]]:
    """-> {epoch: {set: {'json': {m: n}, 'recorders': {m: n},
    'compute': {m: n}, 'where': {tier: bool}}}} sorted by closeness to the
    wanted epoch (ref dictify.py:215-382)."""
    cfg = job.model_cfg
    if wanted_epoch == 'last':
        wanted_epoch = job.trained
    if testset is None:
        testset = job.training_parameters.get('set')
    if oodsets is None:
        from ..data.registry import get_same_size_by_name
        try:
            oodsets = get_same_size_by_name(testset)
        except Exception:
            oodsets = []

    pm = (cfg.predict_methods if predict_methods == 'all'
          else list(predict_methods))
    om = (develop_starred_methods(cfg.ood_methods, METHODS_PARAMS)
          if ood_methods == 'all' else list(ood_methods))
    mm = (develop_starred_methods(cfg.misclass_methods, METHODS_PARAMS)
          if misclass_methods == 'all' else list(misclass_methods))

    epochs = set()
    if isinstance(wanted_epoch, int):
        epochs.add(wanted_epoch)
    epochs |= {e for e in job.testing if isinstance(e, int)}
    epochs |= {e for e in job.ood_results if isinstance(e, int)}
    if job.saved_dir and os.path.isdir(os.path.join(job.saved_dir, 'samples')):
        for d in os.listdir(os.path.join(job.saved_dir, 'samples')):
            if d.isdigit():
                epochs.add(int(d))
    epochs = sorted(e for e in epochs
                    if abs(e - wanted_epoch) <= epoch_tolerance)
    epochs.sort(key=lambda e: (abs(e - wanted_epoch), -e))

    out: Dict[int, Dict[str, dict]] = {}
    for epoch in epochs:
        sets = {}
        sdir = (os.path.join(job.saved_dir, 'samples', '{:04d}'.format(epoch))
                if job.saved_dir else None)
        recorders = (LossRecorder.loadall(sdir, output='paths')
                     if sdir else {})
        for s in [testset] + list(oodsets or []):
            if s is None:
                continue
            avail = {'json': {}, 'recorders': {}, 'compute': {}}
            methods = om if s != testset else (om + pm + mm)
            json_src = (job.testing.get(epoch, {}) if s == testset
                        else job.ood_results.get(epoch, {}).get(s, {}))
            rec = None
            if s in recorders:
                # metadata-only probe — planning must not read array data
                # (fleet queries would otherwise pull whole score tensors
                # from disk per epoch x set)
                try:
                    rec = LossRecorder.peek(recorders[s])
                except Exception:
                    rec = None
            for m in methods:
                if m in mm and s == testset:
                    # misclass results are stored nested under the predict
                    # method (engines.misclassification_detection_rates):
                    # testing[epoch][pm][m] -> take the best-covered pm
                    n_json = max((p.get(m, {}).get('n', 0)
                                  for p in json_src.values()
                                  if isinstance(p, dict)), default=0)
                else:
                    r = json_src.get(m)
                    n_json = r.get('n', 0) if isinstance(r, dict) else 0
                avail['json'][m] = n_json if 'json' in where else 0
                n_rec = 0
                if rec is not None and 'recorders' in where:
                    if all(c in rec['components']
                           for c in needed_components(m)):
                        n_rec = rec['recorded_samples']
                avail['recorders'][m] = n_rec
                avail['compute'][m] = (10 ** 9 if 'compute' in where
                                       and epoch == job.trained else 0)
            avail['where'] = {
                t: any(avail[t].values()) for t in ('json', 'recorders',
                                                    'compute')}
            sets[s] = avail
        out[epoch] = sets
    return out


def make_dict_from_model(job: Job, directory: Optional[str] = None,
                         wanted_epoch='last', tpr: float = 0.95,
                         oodsets: Optional[Sequence[str]] = None,
                         epoch_tolerance: Optional[int] = None
                         ) -> Dict[str, Any]:
    """Flat summary dict per job (ref dictify.py:474-876).

    Key families: identity/arch, training hyper-parameters, history-derived
    metrics at the wanted epoch (test/train/validation losses, rmse/dB,
    bits-per-dim nll), accuracy per predict method, and per-(ood set, method)
    auc / fpr@tpr / n / mean / std grids plus the cross-set 'average'.
    ``wanted_epoch`` may be an int, 'last', or 'min-loss' (the early-stopping
    epoch cached in train_params, ref utils/testing.py).
    """
    cfg = job.model_cfg
    tp = job.training_parameters
    opt = job.opt_cfg
    if wanted_epoch == 'min-loss':
        wanted_epoch = tp.get('early-min-loss', 'last')
    if wanted_epoch == 'last':
        wanted_epoch = job.trained

    arch_str = _arch_string(cfg)
    d = {
        'job': job.job_number,
        'dir': directory or job.saved_dir,
        'type': cfg.type,
        'set': tp.get('set'),
        'arch': arch_str,
        # stable digest: Python hash() is salted per process, which would
        # fragment groupby keys across sessions (ref uses hashlib, dictify.py)
        'arch_code': format(zlib.crc32(arch_str.encode()), 'x'),
        'features': cfg.features or 'none',
        'upsampler': cfg.upsampler or 'none',
        'encoder': '-'.join(map(str, cfg.encoder)),
        'decoder': '-'.join(map(str, cfg.decoder)),
        'classifier': '-'.join(map(str, cfg.classifier)) or 'none',
        'depth': cfg.depth,
        'width': cfg.width,
        'K': cfg.latent_dim,
        'latent_dim': cfg.latent_dim,
        'L': cfg.latent_sampling,
        'latent_sampling': cfg.latent_sampling,
        'test_latent_sampling': cfg.test_latent_sampling,
        # a plain constant stays numeric so float filters match
        # (filters.ini types sigma as float; ref dictify compares the
        # Sigma tensor numerically); stateful modes keep the describe()
        # string ('rmse', '1->rmse[-0.1*]', 'coded ...')
        'sigma': (float(cfg.sigma_cfg.value)
                  if not (cfg.sigma_cfg.is_rmse or cfg.sigma_cfg.learned
                          or cfg.sigma_cfg.coded or cfg.sigma_cfg.decay)
                  else cfg.sigma_cfg.describe()),
        'sigma_train': ('rmse' if cfg.sigma_cfg.is_rmse else
                        ('learned' if cfg.sigma_cfg.learned else 'constant')),
        'beta': cfg.beta,
        'gamma': cfg.gamma,
        'prior': cfg.prior.distribution,
        'prior_variance': cfg.prior.var_dim,
        'prior_means': cfg.prior.init_mean,
        'learned_prior_means': cfg.prior.learned_means,
        'tilted_tau': cfg.prior.tau if cfg.prior.distribution != 'gaussian'
                      else None,
        'forced_var': cfg.encoder_forced_variance,
        'output_distribution': cfg.output_distribution,
        'batch_norm': cfg.batch_norm or 'none',
        'activation': cfg.activation,
        'output_activation': cfg.output_activation,
        'optim': opt.optim_type,
        'lr': opt.lr,
        'lr_decay': opt.lr_decay,
        'grad_clipping': opt.grad_clipping,
        'batch_size': tp.get('batch_size'),
        'data_augmentation': '-'.join(tp.get('data_augmentation') or []) or 'none',
        'epochs': tp.get('epochs', 0),
        'done': job.trained,
        # fraction of the planned run (ref 'trained', dictify.py:826)
        'trained': (job.trained / tp['epochs'] if tp.get('epochs')
                    else float(job.trained > 0)),
        'finished': job.trained >= (tp.get('epochs') or 0),
        'validation': tp.get('validation', 0),
        'has_validation': False,
        'full_test_every': tp.get('full_test_every'),
        'warmup': (tp.get('warmup') or (0, 0))[-1],
        'warmup_gamma': (tp.get('warmup_gamma') or (0, 0))[-1],
        'transformer': tp.get('transformer', 'default'),
        'train_batch_size': tp.get('batch_size'),
        'rep': cfg.representation,
        'epoch': wanted_epoch,
        'early_min_loss': tp.get('early-min-loss'),
        'optim_str': '{} lr={:g}'.format(opt.optim_type, opt.lr),
        'wim': bool(tp.get('wim')),
        'wim_prior': (tp.get('wim') or {}).get('distribution'),
        'wim_mean': (tp.get('wim') or {}).get('init_mean'),
        'wim_sets': '-'.join(sorted((tp.get('wim') or {}).get('sets', [])))
                    or None,
        'wim_alpha': None,
        'wim_train_size': None,
        'wim_moving_size': None,
        'wim_mix': (tp.get('wim') or {}).get('mix'),
        'wim_padding': (tp.get('wim') or {}).get('padding'),
        'wim_padding_dataset': (tp.get('wim') or {}).get('padding_dataset'),
        'wim_mix_padding': (tp.get('wim') or {}).get('mix_padding'),
        'wim_array_size': (tp.get('wim') or {}).get('array_size'),
        'wim_from': None,
        'l': cfg.test_latent_sampling,
        'classif_type': cfg.classifier_type or 'none',
        'pretrained_features': tp.get('pretrained_features'),
        'pretrained_upsampler': tp.get('pretrained_upsampler'),
        'version': cfg.version,
    }
    for ft in tp.get('fine_tuning') or []:
        if isinstance(ft, dict) and ft.get('type') == 'wim':
            d['wim_alpha'] = ft.get('alpha')
            d['wim_train_size'] = ft.get('train_size')
            d['wim_moving_size'] = ft.get('moving_size')
            d['wim_from'] = ft.get('from_epoch')

    # name grammar: heldout classes + the parent set (ref dictify.py:810-813)
    try:
        from ..data.registry import get_heldout_classes_by_name
        parent, heldout = get_heldout_classes_by_name(d['set'] or '')
        d['parent_set'] = parent
        d['heldout'] = tuple(sorted(heldout))
    except Exception:
        d['parent_set'], d['heldout'] = d['set'], ()

    # sentinels (ref fetch.py:260-285, cvae.py:2713-2722)
    jdir = d['dir']
    for sentinel, key in (('RESUMED', 'is_resumed'), ('derailed', 'derailed'),
                          ('deleted', 'deleted')):
        d[key] = bool(jdir) and os.path.exists(os.path.join(jdir, sentinel))

    # sigma summary (ref dictify.py:684-700)
    scfg = cfg.sigma_cfg
    d['sigma_size'] = 'M' if scfg.per_dim else 'S'
    d['beta_sigma'] = (scfg.value * (cfg.beta ** 0.5)
                       if not scfg.is_rmse else None)

    # ---- history-derived metrics at the closest history epoch ------------
    # (ref dictify.py:656-682: rmse/dB at epoch, test/train/validation loss,
    # bits-per-dim nll from the iws estimate)
    import numpy as np
    hist_epochs = [e for e in job.train_history
                   if isinstance(e, int) and isinstance(job.train_history[e],
                                                        dict)]
    d['recorded_epoch'] = None
    if job.saved_dir:
        sd = os.path.join(job.saved_dir, 'samples')
        if os.path.isdir(sd):
            rec_epochs = [int(x) for x in os.listdir(sd) if x.isdigit()
                          and os.listdir(os.path.join(sd, x))]
            if rec_epochs:
                d['recorded_epoch'] = min(
                    rec_epochs, key=lambda e: abs(e - wanted_epoch))
    if hist_epochs:
        he = min(hist_epochs, key=lambda e: abs(e - wanted_epoch))
        h = job.train_history[he]
        d['history_epoch'] = he
        d['lr_at_epoch'] = h.get('lr')
        for split in ('train', 'test', 'validation'):
            losses = h.get('{}_loss'.format(split)) or {}
            for comp in ('total', 'kl', 'zdist', 'iws', 'cross_x'):
                if comp in losses:
                    d['{}_{}'.format(split, comp)] = losses[comp]
            if split != 'validation' and 'total' in losses:
                d['{}_loss'.format(split)] = losses['total']
        if 'validation_loss' in h:
            d['has_validation'] = True
            d['validation_loss'] = (h['validation_loss'] or {}).get('total')
        measures = h.get('test_measures') or h.get('train_measures') or {}
        for k in ('rmse', 'dB', 'mse'):
            if k in measures:
                d[k] = measures[k]
        if 'sigma' in measures:
            # keep 'sigma' as the config descriptor (filter key); the
            # trained value at the epoch gets its own key (ref dictify.py
            # 'sigma at epoch' history keys)
            d['sigma_at_epoch'] = measures['sigma']
        for zk in ('test_zdist', 'train_zdist'):
            if zk in d:
                # reported as a distance, not the squared sum
                # (ref dictify.py:844-845)
                d[zk] = float(np.sqrt(max(d[zk], 0.0)))
        # bits-per-dim from the iws evidence estimate (ref dictify.py:672-678)
        iws = (h.get('test_loss') or {}).get('iws')
        if iws is not None:
            D = 1
            for s_ in cfg.input_shape:
                D *= s_
            nll = -iws / np.log(2) / D
            if cfg.type in ('cvae', 'xvae'):
                nll += np.log2(cfg.num_labels) / D
            d['nll'] = float(nll)
        if 'kl' not in d and 'test_kl' in d:
            d['kl'] = d['test_kl']

    # ---- accuracy per predict method at the closest epoch ----------------
    epoch = _closest(job.testing, wanted_epoch, epoch_tolerance)
    if epoch is not None:
        n_tested = []
        for m, r in job.testing[epoch].items():
            if isinstance(r, dict) and 'accuracy' in r:
                d['accuracy_{}'.format(m)] = r['accuracy']
                n_tested.append(r.get('n', 0))
        accs = [v for k, v in d.items() if k.startswith('accuracy_')]
        if accs:
            d['accuracy'] = d['best_accuracy'] = max(accs)
            d['accuracy_epoch'] = epoch
            d['n_tested'] = min(n_tested) if n_tested else 0
            first = (cfg.predict_methods or [None])[0]
            if 'accuracy_{}'.format(first) in d:
                d['accuracy_first'] = d['accuracy_{}'.format(first)]

    # ---- per-(ood set, method) grids + best-method summary ----------------
    epoch = _closest(job.ood_results, wanted_epoch, epoch_tolerance)
    if epoch is not None:
        per_set_best = {}
        for s, per_method in job.ood_results[epoch].items():
            if oodsets is not None and s not in oodsets:
                # an explicit oodsets list restricts which sets appear
                # (ref dictify.py:545+ via test.py --sets / [options] ood)
                continue
            aucs = {m: r.get('auc') for m, r in per_method.items()
                    if isinstance(r, dict) and r.get('auc') is not None}
            for m, r in per_method.items():
                if not isinstance(r, dict):
                    continue
                base = 'ood_{}_{}'.format(s, m)
                for k in ('auc', 'n', 'mean', 'std'):
                    if r.get(k) is not None:
                        d['{}_{}'.format(base, k)] = r[k]
                # the full kept-TPR grid per method — tables select their
                # own tpr level (results INI `tpr` option) and must not
                # fall back to a different method's numbers
                for t, f in zip(r.get('tpr') or [], r.get('fpr') or []):
                    tt = int(round(100 * t))
                    if abs(100 * t - tt) < 1e-6:
                        d['{}_fpr{}'.format(base, tt)] = f
            if aucs:
                best = max(aucs, key=aucs.get)
                per_set_best[s] = (aucs[best], best, per_method[best])
                d['ood_{}_auc'.format(s)] = aucs[best]
                d['ood_{}_method'.format(s)] = best
                d['ood_{}_n'.format(s)] = per_method[best].get('n')
                r = per_method[best]
                if r.get('fpr') and r.get('tpr'):
                    # one column per kept-TPR grid point (fpr90..fpr99),
                    # selected per-table via the results INI `tpr` option
                    for t, f in zip(r['tpr'], r['fpr']):
                        tt = int(round(100 * t))
                        if abs(100 * t - tt) < 1e-6:
                            d['ood_{}_fpr{}'.format(s, tt)] = f
        # cross-set average over the requested (or all) ood sets
        # (ref average_ood_results, dictify.py:552-565)
        avg_over = [s for s in (oodsets or per_set_best) if s in per_set_best]
        if avg_over:
            d['ood_average_auc'] = float(
                np.mean([per_set_best[s][0] for s in avg_over]))
            tt = int(round(100 * tpr))
            fprs = [d.get('ood_{}_fpr{}'.format(s, tt)) for s in avg_over]
            fprs = [f for f in fprs if f is not None]
            if fprs:
                d['ood_average_fpr{}'.format(tt)] = float(np.mean(fprs))
            d['ood_average_over'] = '-'.join(sorted(avg_over))

    # ---- misclassification detection per predict method -------------------
    # (ref in_out 'errors-' rows, dictify.py:574-585)
    epoch = _closest(job.testing, wanted_epoch, epoch_tolerance)
    if epoch is not None:
        for pm, r in job.testing[epoch].items():
            if not isinstance(r, dict):
                continue
            for mm, rr in r.items():
                if isinstance(rr, dict) and rr.get('auc') is not None:
                    base = 'errors_{}_{}'.format(pm, mm)
                    d['{}_auc'.format(base)] = rr['auc']
                    f = _fpr_at(rr, tpr)
                    if f is not None:
                        d['{}_fpr{}'.format(base,
                                             int(round(100 * tpr)))] = f
    return d


def _fpr_at(r: dict, tpr: float) -> Optional[float]:
    for t, f in zip(r.get('tpr') or [], r.get('fpr') or []):
        if abs(t - tpr) < 1e-4:
            return f
    return None


def _closest(results: Dict, wanted: int,
             tolerance: Optional[int] = None) -> Optional[int]:
    epochs = [e for e in results if isinstance(e, int) and results[e]]
    if tolerance is not None:
        epochs = [e for e in epochs if abs(e - wanted) <= tolerance]
    if not epochs:
        return None
    return min(epochs, key=lambda e: abs(e - wanted))


def _arch_string(cfg) -> str:
    """Compact architecture string used in job paths and summaries
    (the spirit of ref print_architecture)."""
    parts = [cfg.type]
    if cfg.features:
        parts.append(cfg.features)
    parts.append('e' + '-'.join(map(str, cfg.encoder)))
    parts.append('K{}'.format(cfg.latent_dim))
    if cfg.x_is_generated:
        parts.append('d' + '-'.join(map(str, cfg.decoder)))
        if cfg.upsampler:
            parts.append(cfg.upsampler)
    clf = '-'.join(map(str, cfg.classifier))
    if clf:
        parts.append('c' + clf)
    parts.append(cfg.prior.distribution)
    if cfg.prior.conditional:
        parts.append('cond')
    return '--'.join(parts)
