"""Cascaded-models CLI (ref module/cascad.py CLI + results/cascad.py +
results/mutual_info.py), on the CUDA card unless ``--device cpu``.

    python -m joint_vae_tpu_torch.cli.cascade <job> <job> ... --job-dir jobs

Port of ``joint_vae_tpu/cli/cascade.py``.  Feeds model i+1 with the
reconstruction of model i on the shared test set; reports per-stage
losses and accuracy, the cross-stage reconstruction MSE matrix Im(T),
Bayes-iterated posterior accuracy, and writes the artifacts under the
first job's samples dir.  Stage i draws its noise from
``fold_in(seed, i)``, the ``--record`` pair i from ``fold_in(seed, 7 + i)``.
"""

import argparse
import logging
import os
import sys
import tempfile

import numpy as np

from ..data.loaders import get_batch, get_dataset
from ..evals.aggregation import latent_mutual_info_tensors
from ..evals.cascad import CascadModels, iterate_with_prior
from ..save_load.checkpoint import save_json
from ..save_load.fetch import find_by_job_number
from ..save_load.recorders import LossRecorder, record_filename
from ..train.state import fold_in
from . import add_device_arg


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-cascade')
    p.add_argument('jobs', nargs='*', type=int)
    p.add_argument('--jobs', '-j', dest='jobs_flag', nargs='+', type=int,
                   default=[], help="the reference's flag spelling of the "
                                    'job list (module/cascad.py:207)')
    p.add_argument('--job-dir', default='jobs')
    p.add_argument('-N', type=int, default=None,
                   help='total samples (default: batch-size x num-batch '
                        'capped to the set)')
    p.add_argument('--batch-size', type=int, default=512)
    p.add_argument('--num-batch', type=int, default=1,
                   help='with --batch-size, sets -N (ref cascad.py:218-219)')
    p.add_argument('--when', default='last',
                   help='(accepted for reference compatibility; stages '
                        'always evaluate the loaded checkpoint)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--out', '--cascad-job-dir', default=None)
    p.add_argument('--tex', nargs='?', default=None,
                   const=os.path.join(tempfile.gettempdir(), 'r.tex'),
                   help='write the per-stage table as LaTeX (ref '
                        'cascad.py:212; without a path, r.tex in the '
                        'temporary directory)')
    p.add_argument('--saved-samples-per-batch', type=int, default=None,
                   help='(accepted for reference compatibility; --record '
                        'stores whole-batch tensors)')
    p.add_argument('--record', action='store_true',
                   help='record per-sample latent-agreement Im-<T> tensors '
                        'for every consecutive stage pair, stacked on a '
                        'leading pair axis, into '
                        '<job-dir>/<set>/<j1-j2-...>/record-<set>.npz '
                        '(ref cascad.py:162; consumed by '
                        'results.mutual_info)')
    p.add_argument('-T', '--temps', nargs='*', type=float,
                   default=[1.0, 2.0, 5.0])
    p.add_argument('-v', '--verbose', action='count', default=0)
    p.add_argument('--debug', action='store_true')
    add_device_arg(p)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)

    args.jobs = list(args.jobs) + list(args.jobs_flag)
    if not args.jobs:
        sys.exit('no jobs given (positional or --jobs)')
    if args.N is None:
        args.N = args.batch_size * args.num_batch

    jobs = []
    for n in args.jobs:
        j = find_by_job_number(args.job_dir, n, device=args.device)
        if j is None:
            sys.exit('job {} not found'.format(n))
        jobs.append(j)

    name = jobs[0].training_parameters.get('set')
    _, testset = get_dataset(name, splits=['test'])
    x, y = get_batch(testset, min(args.N, len(testset)), seed=args.seed)

    casc = CascadModels(*jobs)
    stage_losses, recos, mse, posteriors = casc.evaluate(x, seed=args.seed)

    print('cross-stage reconstruction MSE matrix Im(T):')
    for row in mse:
        print('  ' + ' '.join('{:9.5f}'.format(v) for v in row))

    report = {'sets': name, 'jobs': args.jobs, 'n': int(len(x)),
              'im_t': mse.tolist(), 'stages': []}
    for i, (job, losses) in enumerate(zip(jobs, stage_losses)):
        entry = {'job': job.job_number,
                 'mean_losses': {k: float(np.mean(v))
                                 for k, v in losses.items()}}
        post = posteriors[i]
        if post is not None:
            acc = float((post.argmax(0) == y).mean())
            entry['accuracy'] = acc
            print('stage {} (job {}): total {:.4f}  acc {:.2%}'.format(
                i, job.job_number, entry['mean_losses']['total'], acc))
        report['stages'].append(entry)

    usable = [p_ for p_ in posteriors if p_ is not None]
    if usable:
        it = iterate_with_prior(usable)
        acc_it = float((it.argmax(0) == y).mean())
        report['iterated_accuracy'] = acc_it
        print('bayes-iterated accuracy: {:.2%}'.format(acc_it))

    if args.tex:
        os.makedirs(os.path.dirname(args.tex) or '.', exist_ok=True)
        with open(args.tex, 'w') as f:
            f.write('% cascade {} on {} (n={})\n'.format(
                '-'.join(map(str, args.jobs)), name, len(x)))
            f.write('\\begin{tabular}{rrrr}\n\\toprule\n')
            f.write('stage & job & total & acc \\\\\n\\midrule\n')
            for i, entry in enumerate(report['stages']):
                acc = entry.get('accuracy')
                f.write('{} & {} & {:.4f} & {} \\\\\n'.format(
                    i, entry['job'], entry['mean_losses']['total'],
                    '{:.2%}'.format(acc).replace('%', '\\%')
                    if acc is not None else '--'))
            f.write('\\bottomrule\n\\end{tabular}\n')
        print('tex table written to {}'.format(args.tex))

    out = args.out or (os.path.join(jobs[0].saved_dir, 'samples', 'cascade')
                       if jobs[0].saved_dir else 'cascade')
    os.makedirs(out, exist_ok=True)
    save_json(report, os.path.join(out, 'cascade.json'))
    np.savez(os.path.join(out, 'cascade-recos.npz'), recos=recos, mse=mse)

    if args.record and len(jobs) >= 2:
        rec_dir = os.path.join(args.job_dir, name,
                               '-'.join(str(n) for n in args.jobs))
        os.makedirs(rec_dir, exist_ok=True)
        rec = LossRecorder(len(x))
        pair_im = {T: [] for T in args.temps}
        y_hat = None
        for i in range(len(jobs) - 1):
            Im, yh = latent_mutual_info_tensors(
                jobs[i], jobs[i + 1], x, temps=args.temps,
                seed=fold_in(args.seed, 7 + i))
            for T in args.temps:
                pair_im[T].append(Im[T])
            if y_hat is None:
                y_hat = yh
        rec.append_batch(
            **{'Im-{:g}'.format(T): np.stack(v) for T, v in pair_im.items()},
            y_=y_hat, y_true=np.asarray(y))
        path = os.path.join(rec_dir, record_filename(name))
        rec.save(path)
        print('recorded stage-pair Im tensors -> {}'.format(path))

    print('written to {}'.format(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
