"""Sample-grid CLI (ref module/sample.py:277-491), on the CUDA card
unless ``--device cpu``.

    python -m joint_vae_tpu_torch.cli.sample <job-number> --job-dir jobs \
        [--grids reco gen zsample] [-N 8] [-L 8] [--out samples-out]

Port of ``joint_vae_tpu/cli/sample.py``.  Generates reconstruction grids
(test / correct / incorrect / OOD rows), pure-generation grids from the
prior, and latent mu/sigma exports; ``--compare`` adds a side-by-side
mean-reconstruction grid of other jobs.  Each grid is written as ``.npz``
and, when PIL imports, as ``.png``.
"""

import argparse
import json
import logging
import os
import sys

import numpy as np

from ..data.loaders import get_batch, get_dataset
from ..evals.sample import (compare_reconstructions, generation_grid,
                            latent_samples, reconstruction_grid, save_grid_image,
                            save_png, select_correct_incorrect)
from ..save_load.fetch import fetch_models, find_by_job_number
from ..train.state import make_generator
from ..utils.inspection import export_latent_histograms
from . import add_device_arg


def _forwarded_args(args):
    """Re-spell the per-job options for fleet recursion (no job number)."""
    fwd = ['--job-dir', args.job_dir, '-N', str(args.N), '-L', str(args.L),
           '--total-width', str(args.total_width),
           '--batch-size', str(args.batch_size),
           '--num-batch-for-test', str(args.num_batch_for_test),
           '--bins', str(args.bins), '--seed', str(args.seed),
           '--grids'] + list(args.grids)
    if args.z_sample:
        fwd += ['--z-sample', str(args.z_sample)]
    if args.out:
        fwd += ['--out', args.out]
    if args.device:
        fwd += ['--device', args.device]
    return fwd


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-sample')
    p.add_argument('job', type=int, nargs='?', default=None)
    p.add_argument('--job-dir', default='jobs')
    p.add_argument('--last', type=int, default=0,
                   help='without a job number: sample the N highest-'
                        'numbered jobs (ref module/sample.py --last)')
    p.add_argument('--list-jobs-and-quit', action='store_true')
    p.add_argument('--grids', nargs='*', default=['reco', 'gen', 'zsample'],
                   choices=['reco', 'gen', 'zsample', 'ood'])
    p.add_argument('-N', '--grid-height', dest='N', type=int, default=8)
    p.add_argument('-L', '--sampling', dest='L', type=int, default=8)
    p.add_argument('--total-width', type=int, default=30,
                   help='max images per grid row (ref module/sample.py)')
    p.add_argument('--batch-size', '-m', type=int, default=256,
                   help='eval batch size for pool scans / latent exports')
    p.add_argument('--num-batch-for-test', type=int, default=1,
                   help='batches scanned for the latent exports')
    p.add_argument('--z-sample', type=int, default=0,
                   help='latent-export sample count (0 = batch-size x '
                        'num-batch-for-test; ref --z-sample)')
    p.add_argument('--bins', type=int, default=50,
                   help='histogram bins for hist-of-var (ref --bins)')
    p.add_argument('--compare', nargs='*', type=int, default=[],
                   help='other job numbers: side-by-side mean-reconstruction'
                        ' grid + pairwise-MSE matrix (ref comparison mode)')
    p.add_argument('--out', '--directory', default=None)
    p.add_argument('--seed', type=int, nargs='?', const=1, default=0)
    p.add_argument('--look-for-missed', type=int, default=0,
                   help='(accepted for reference compatibility; grids are '
                        'always regenerated here)')
    p.add_argument('--stop-if-missing', action='store_true',
                   help='(accepted for reference compatibility)')
    p.add_argument('--plot', '-p', nargs='?', const='all', default=None,
                   help='(accepted for reference compatibility; grids are '
                        'written as files, no display backend)')
    p.add_argument('-v', '--verbose', action='count', default=0)
    p.add_argument('--debug', action='store_true')
    add_device_arg(p)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)

    if args.plot or args.look_for_missed or args.stop_if_missing:
        logging.warning('--plot/--look-for-missed/--stop-if-missing are '
                        'accepted for reference compatibility but inert '
                        '(grids are always (re)written as files)')
    if args.job is None:
        models = sorted(fetch_models(args.job_dir),
                        key=lambda m: m.get('job') or 0)
        if args.last:
            models = models[-args.last:]
        if args.list_jobs_and_quit:
            for m in models:
                print(m.get('job'), m.get('dir'))
            return 0
        rc = 0
        for m in models:
            rc |= main([str(m['job'])] + _forwarded_args(args))
        return rc

    job = find_by_job_number(args.job_dir, args.job, device=args.device)
    if job is None:
        sys.exit('job {} not found'.format(args.job))
    args.N = min(args.N, args.total_width)
    out_dir = args.out or os.path.join(job.saved_dir, 'samples', 'grids')
    # the reference's root default is 'results/%j/samples' — %j expands to
    # the job number (module/sample.py:279)
    out_dir = out_dir.replace('%j', str(args.job))
    os.makedirs(out_dir, exist_ok=True)
    dev = job.device

    dataset = job.training_parameters.get('set')
    _, testset = get_dataset(dataset, splits=['test'])
    x, y = get_batch(testset, args.N, seed=args.seed)

    if 'reco' in args.grids:
        grid = reconstruction_grid(job, x, y, L=args.L,
                                   generator=make_generator(dev, args.seed))
        save_grid_image(grid, os.path.join(out_dir, 'reco-{}'.format(dataset)))
        # correct / incorrect rows pooled across the whole test set
        # (ref module/sample.py:437-466)
        pools = select_correct_incorrect(job, testset, args.N,
                                         batch_size=args.batch_size,
                                         seed=args.seed)
        for name, (xp, yp) in pools.items():
            if not len(xp):
                continue
            g = reconstruction_grid(job, xp, yp, L=args.L,
                                    generator=make_generator(dev, args.seed))
            g.pop('correct', None)
            save_grid_image(g, os.path.join(out_dir, 'reco-{}'.format(name)))

    if 'ood' in args.grids:
        for n in testset.same_size[:2]:
            try:
                _, ood = get_dataset(n, splits=['test'])
            except Exception:
                continue
            xo, _ = get_batch(ood, args.N, seed=args.seed)
            grid = reconstruction_grid(job, xo, L=args.L)
            save_grid_image(grid, os.path.join(out_dir, 'reco-ood-{}'.format(n)))

    if 'gen' in args.grids:
        gen = generation_grid(job, n_per_class=args.N, seed=args.seed + 1)
        np.savez(os.path.join(out_dir, 'generation.npz'), x=gen)
        save_png([gen[c] for c in range(min(gen.shape[0], 10))],
                 os.path.join(out_dir, 'generation.png'))

    if args.compare:
        others, numbers = [], []
        for n in args.compare:
            if n == args.job:
                continue
            other = find_by_job_number(args.job_dir, n, device=args.device)
            if other is None:
                sys.exit('comparison job {} not found'.format(n))
            if other.model_cfg.input_shape != job.model_cfg.input_shape:
                sys.exit('comparison job {} has input shape {} != {}'.format(
                    n, other.model_cfg.input_shape, job.model_cfg.input_shape))
            others.append(other)
            numbers.append(n)
        mse, recos = compare_reconstructions([job] + others, x,
                                             seed=args.seed)
        base = os.path.join(out_dir, 'comparison')
        np.savez(base + '.npz', input=np.asarray(x), recos=recos, mse=mse,
                 jobs=np.asarray([args.job] + numbers))
        save_png([np.asarray(x)] + list(recos), base + '.png')
        with open(base + '.json', 'w') as f:
            json.dump({'jobs': [args.job] + numbers,
                       'mse': mse.tolist()}, f, indent=1)

    if 'zsample' in args.grids:
        n_z = args.z_sample or args.batch_size * args.num_batch_for_test
        xb, yb = get_batch(testset, min(len(testset), n_z), seed=args.seed)
        mu, lv, z = latent_samples(job, xb)
        export_latent_histograms(mu, lv, out_dir, y=yb, bins=args.bins)

    print('grids written to {}'.format(out_dir))
    return 0


if __name__ == '__main__':
    sys.exit(main())
