"""Recorded-Im(T) tables (ref results/mutual_info.py:9-249).

    python -m joint_vae_tpu_torch.results.mutual_info <dir> [...] [--tpr 95]

Port of ``joint_vae_tpu/results/mutual_info.py``; host only (numpy).

Each <dir> is an aggregation recording directory
(``<job-dir>/<set>/<j1|j2>/`` written by ``cli.aggregate --record``, or a
cascade dir with ``Im-i-j`` keys) holding ``record-<set>.npz`` files with
per-sample ``Im-<T>`` tensors.  For every temperature T the pipeline
reports: ensemble accuracy, the mean Im over correct / incorrect /
in-distribution / each OOD set, the Im threshold keeping ``tpr`` of the
correct samples, and each OOD set's FPR and detection precision at that
threshold.
"""

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np

from ..save_load.recorders import LossRecorder


def _im_keys(rec) -> Dict[float, str]:
    out = {}
    for k in rec.keys():
        if k.startswith('Im-'):
            try:
                # everything past the prefix IS the '{:g}' temperature —
                # split('-') would mangle 'Im-5e-05' or a negative T
                out[float(k[len('Im-'):])] = k
            except ValueError:
                continue
    return out


def process_directory(folder: str, tpr: float = 0.95,
                      dataset: Optional[str] = None) -> Optional[Dict]:
    """-> {T: {'acc', 'im_correct', 'im_incorrect', 'threshold',
    'ood': {set: {'im', 'fpr', 'precision'}}}} or None when the folder has
    no Im recordings."""
    # header-only probe first: most walked dirs hold plain loss recorders
    # with no Im keys — don't materialize their tensors (peek is a .jvr
    # header read / lazy npz member listing)
    paths = LossRecorder.loadall(folder, output='paths')
    if not paths:
        return None
    if not any(k.startswith('Im-')
               for p in paths.values()
               for k in LossRecorder.peek(p).get('components', ())):
        return None
    recorders = LossRecorder.loadall(folder)
    if not recorders:
        return None
    if dataset is None:
        # our layout: <job-dir>/<set>/<j1|j2>; fall back to the first set
        parent = os.path.basename(os.path.dirname(os.path.abspath(folder)))
        dataset = parent if parent in recorders else next(iter(recorders))
    if dataset not in recorders:
        return None
    ind = recorders[dataset]
    temps = _im_keys(ind)
    if not temps:
        return None

    y_true = np.asarray(ind.get('y_true'))
    y_hat = np.asarray(ind.get('y_')) if 'y_' in ind else None

    def _per_sample(rec, key):
        """(N,) Im vector; cascade recordings stack stage pairs on a
        leading axis (ref cascad.py:162) — averaged here."""
        a = np.asarray(rec.get(key))
        return a.reshape(-1, a.shape[-1]).mean(0) if a.ndim > 1 else a

    out: Dict = {}
    for T, key in sorted(temps.items()):
        im = _per_sample(ind, key)
        row = {'n': len(im), 'im_ind': float(im.mean())}
        if y_hat is not None:
            correct = y_hat.ravel()[:len(im)] == y_true.ravel()[:len(im)]
            row['acc'] = float(correct.mean())
            if correct.any():
                imc = im[correct]
                row['im_correct'] = float(imc.mean())
                # threshold keeping `tpr` of the correct samples above it
                thr = float(np.sort(imc)[int(len(imc) * (1 - tpr))])
                row['threshold'] = thr
            if (~correct).any():
                row['im_incorrect'] = float(im[~correct].mean())
        row['ood'] = {}
        # loop-invariant: fraction of in-distribution samples kept
        tp_rate = (float((im >= row['threshold']).mean())
                   if 'threshold' in row else None)
        for s, rec in recorders.items():
            if s == dataset or key not in rec:
                continue
            imo = _per_sample(rec, key)
            entry = {'im': float(imo.mean())}
            if tp_rate is not None:
                fp_rate = float((imo >= row['threshold']).mean())
                entry['fpr'] = fp_rate
                # balanced-prior precision from rates, not pooled counts —
                # invariant to the (arbitrary) ind/OOD set-size ratio
                entry['precision'] = tp_rate / max(tp_rate + fp_rate, 1e-12)
            row['ood'][s] = entry
        out[T] = row
    return out


def print_table(folder: str, res: Dict, tpr: float):
    print('== {} (tpr {:.0%}) =='.format(folder, tpr))
    oods = sorted({s for r in res.values() for s in r['ood']})
    hdr = ['T', 'acc', 'Im[ok]', 'Im[ko]', 'thr']
    for s in oods:
        hdr += ['{}:fpr'.format(s), '{}:P'.format(s)]
    print(' '.join('{:>10}'.format(h) for h in hdr))
    for T, r in res.items():
        cells = ['{:>10g}'.format(T),
                 '{:>10}'.format('{:.1%}'.format(r['acc'])
                                 if 'acc' in r else '--'),
                 '{:>10.3g}'.format(r.get('im_correct', float('nan'))),
                 '{:>10.3g}'.format(r.get('im_incorrect', float('nan'))),
                 '{:>10.3g}'.format(r.get('threshold', float('nan')))]
        for s in oods:
            e = r['ood'].get(s, {})
            cells.append('{:>10}'.format('{:.1%}'.format(e['fpr'])
                                         if 'fpr' in e else '--'))
            cells.append('{:>10}'.format('{:.1%}'.format(e['precision'])
                                         if 'precision' in e else '--'))
        print(' '.join(cells))


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-mutual-info')
    p.add_argument('dirs', nargs='+',
                   help='aggregation recording dirs (or a root to walk)')
    p.add_argument('--tpr', type=int, default=95)
    p.add_argument('--dataset', default=None)
    args = p.parse_args(argv)
    tpr = args.tpr / 100

    found = 0
    for d in args.dirs:
        candidates = [d]
        for root, subdirs, files in os.walk(d):
            candidates.extend(os.path.join(root, s) for s in subdirs)
        for c in candidates:
            res = process_directory(c, tpr=tpr, dataset=args.dataset)
            if res:
                print_table(c, res, tpr)
                found += 1
    return 0 if found else 1


if __name__ == '__main__':
    sys.exit(main())
