#!/usr/bin/env python
"""The evidence bands' spread over seeds: each band metric's min and max
over a record's ``'<dtype> seed=<n>'`` runs (``'strong-<dtype> ...'``
for the WIM study's ``--strong``), per dtype, beside its band.

    python scripts/torch_evidence_spread.py [--merge RUN.json ...]

The three studies whose bands missed (``scripts/torch_wim_study.py``,
``torch_poscod_quality.py``, ``torch_wim_inversion_study.py``), run on
the card with ``--seed n --out RUN.json``: ``--merge`` first copies each
run file's runs into its ``docs/*_TORCH.json`` record (a seed-0 run under
``'<dtype> seed=0'``, beside the record's own run).  Each record then
gets ``seed_spread``: per dtype, the seeds, every band metric's
``[min, max]`` and each seed's band misses.  Prints one JSON line.
"""

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = {'torch_wim_study.py': 'WIM_STUDY_TORCH.json',
           'torch_poscod_quality.py': 'POSCOD_QUALITY_TORCH.json',
           'torch_wim_inversion_study.py': 'WIM_INVERSION_TORCH.json'}
SEEDED = re.compile(r'^((?:strong-)?(?:float32|bfloat16)) seed=(\d+)$')


def metrics(script: str, run: dict) -> dict:
    """A run's band metrics, by name (the quantities its band holds)."""
    if script == 'torch_poscod_quality.py':
        out = {}
        for name, r in run['conditions'].items():
            for s, v in r['llr_auroc'].items():
                out['{} / {}'.format(name, s)] = v
        return out
    if script == 'torch_wim_study.py':
        return {'{} / {}'.format(name, s): max(ms.values())
                for name, r in run['conditions'].items()
                for s, ms in r['auroc'].items()}
    out = {}
    for key, rows in run['scores_unrounded'].items():
        llr = [v['auc_llr'] for v in rows.values()]
        if key.startswith('gaussian'):
            out[key + ' llr range'] = max(llr) - min(llr)
        else:
            out[key + ' llr min'] = min(llr)
    return out


def misses(band_met: dict) -> list:
    """The band's entries that were not met."""
    out = []
    for k, v in band_met.items():
        if isinstance(v, dict):
            out += ['{} / {}'.format(k, m) for m in misses(v)]
        elif not v:
            out.append(k)
    return out


def spread(script: str, record: dict) -> dict:
    by_dtype = {}
    for name, run in record['runs'].items():
        m = SEEDED.match(name)
        if m:
            by_dtype.setdefault(m.group(1), {})[int(m.group(2))] = run
    out = {}
    for dtype, runs in sorted(by_dtype.items()):
        seen = {s: metrics(script, r) for s, r in sorted(runs.items())}
        keys = sorted(set.intersection(*(set(v) for v in seen.values())))
        out[dtype] = {
            'seeds': sorted(runs),
            'metrics': {k: [min(v[k] for v in seen.values()),
                            max(v[k] for v in seen.values())] for k in keys},
            'misses': {s: misses(r['band_met']) for s, r in
                       sorted(runs.items())},
            'band': next(iter(runs.values()))['band']}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--merge', nargs='*', default=[])
    p.add_argument('--docs', default=os.path.join(ROOT, 'docs'))
    args = p.parse_args(argv)
    records = {}
    for script, name in RECORDS.items():
        with open(os.path.join(args.docs, name)) as f:
            records[script] = json.load(f)
    for path in args.merge:
        with open(path) as f:
            run_file = json.load(f)
        script = os.path.basename(run_file['script'])
        for name, run in run_file['runs'].items():
            if not SEEDED.match(name):
                name += ' seed=0'
            records[script]['runs'][name] = run
    line = {}
    for script, name in RECORDS.items():
        rec = records[script]
        rec['seed_spread'] = line[script] = spread(script, rec)
        with open(os.path.join(args.docs, name), 'w') as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())
