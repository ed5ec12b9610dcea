"""WIM fine-tuning CLI (ref ft/__main__.py:17-295), on the CUDA card
unless ``--device cpu``.

    python -m joint_vae_tpu_torch.cli.ft <job-number> --job-dir jobs \
        [--wim-prior gaussian --wim-mean 8 --alpha 0.1 --epochs 1 ...]
    python -m joint_vae_tpu_torch.cli.ft <job-number> --poscod ...
    python -m joint_vae_tpu_torch.cli.ft --array <array-dir> --register <dirs...>

Port of ``joint_vae_tpu/cli/ft.py``.  Load a source job as a WIMJob,
build the alternate prior from CLI+config ([wim-default]), build the
moving set, finetune into a NEW job under ``<job-dir>/wim``; or train a
Poscod head; or run the array aggregation pass.  ``--mesh`` (with
``torchrun --nproc-per-node N``) runs the fine-tuning, Poscod and the
latent records on a device mesh; rank 0 draws the job number and writes.
"""

import argparse
import dataclasses
import json
import logging
import os
import sys

import numpy as np

from ..data.loaders import get_dataset
from ..data.registry import get_same_size_by_name
from ..ft.array import WIMArray
from ..ft.datasets import create_moving_set
from ..ft.job import finetune, host_roc, load_wim_job, record_latents
from ..ft.poscod import PoscodJob, save_poscod_head
from ..ft.scheduler import Scheduler
from ..ft.wim import WIMJob
from ..ops.roc import DEFAULT_KEPT_TPR
from ..parallel.mesh import broadcast_object
from ..save_load.checkpoint import is_write_process
from ..save_load.fetch import find_by_job_number
from ..save_load.jobs import save_job
from ..save_load.recorders import SampleRecorder
from ..train.state import make_generator
from ..utils.inspection import latent_pca, latent_shift, proj2d_csv
from ..utils.parameters import (load_config_section, next_job_number,
                                refuse_unported)
from ..utils.print_log import EpochOutput
from . import add_device_arg, add_mesh_args, mesh_from_args
from .train import save_dir_for


def _run_poscod(args, job, dflt):
    """Poscod branch: frozen net + 1-logit llr head (ref ft/poscod.py)."""
    dataset = job.training_parameters.get('set')
    _, testset = get_dataset(dataset, splits=['test'])
    ood_names = args.oodsets if args.oodsets is not None else \
        [n for n in get_same_size_by_name(dataset) if not n.endswith('90')][:2]
    moving = create_moving_set(
        dataset, moving_size=int(dflt('moving-size', 512)),
        ood_mix=1.0, oodsets=ood_names, seed=args.seed, task=args.task)
    mesh = args.mesh_obj
    pc = PoscodJob(job=job).finetune(testset, moving,
                                     epochs=int(dflt('epochs', 5)),
                                     batch_size=args.batch_size,
                                     seed=args.seed, mesh=mesh)
    ind_scores = pc.llr_scores(testset, args.test_batch_size, mesh=mesh)
    epoch = job.trained
    job.ood_results.setdefault(epoch, {})
    for n in ood_names:
        _, ood = get_dataset(n, splits=['test'])
        s = pc.llr_scores(ood, args.test_batch_size, mesh=mesh)
        r = host_roc(ind_scores, s)
        # 'n' is the OOD sample count — the reuse tier compares it against
        # the oodset size (evals/engines.py n_wanted; ref cvae.py:1886)
        job.ood_results[epoch].setdefault(n, {})['llr'] = {
            'epochs': epoch, 'n': int(len(s)),
            'mean': float(np.mean(s)), 'std': float(np.std(s)),
            'auc': float(r['auc']),
            'tpr': [float(t) for t in DEFAULT_KEPT_TPR],
            'fpr': r['fpr'].tolist()}
        print('poscod llr vs {}: auroc {:.2%}'.format(n, float(r['auc'])))
    if job.saved_dir:
        job.training_parameters['poscod'] = {'epochs': int(dflt('epochs', 5))}
        # with state: the poscod job is a NEW job dir (frozen net + head)
        # and must reload standalone (load_poscod_job)
        save_job(job, job.saved_dir)
        save_poscod_head(pc, job.saved_dir)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-ft')
    p.add_argument('job', nargs='?', type=int, help='source job number')
    p.add_argument('--job-dir', '-J', '--source-job-dir', default='jobs')
    p.add_argument('--job-number', '-j', type=int, default=0,
                   help='explicit number for the NEW wim job '
                        '(ref ft/__main__.py:30)')
    p.add_argument('--args-from-file', nargs=2, metavar=('FILE', 'INDEX'),
                   default=None,
                   help='read the INDEX-th line of FILE as the argument '
                        'list (SLURM-array pattern, ref ft/__main__.py:91-95)')
    p.add_argument('-W', '--wim-job-dir', default=None,
                   help='root for the NEW fine-tuned job dir (default '
                        '<job-dir>/wim; the source job is never overwritten,'
                        ' ref ft/__main__.py:54,201-206)')
    p.add_argument('--config', default='wim-default')
    p.add_argument('--config-file', default=None)
    p.add_argument('--wim-prior', '--prior', default=None,
                   choices=['gaussian', 'tilted', 'uniform'])
    p.add_argument('--wim-mean', '--prior-means', type=float, default=None)
    p.add_argument('--wim-tau', '--tau', type=float, default=None)
    p.add_argument('--alpha', type=float, default=None)
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--train-size', '-N', type=int, default=None)
    p.add_argument('--moving-size', '-n', type=int, default=None)
    p.add_argument('--mix', type=float, default=None, help='ood mix ratio')
    p.add_argument('--padding', type=float, nargs='?', const=1.0, default=0.0)
    p.add_argument('--mix-padding', type=float, nargs='?', const=1.0,
                   default=0.0)
    p.add_argument('--padding-sets', nargs='*', default=[])
    p.add_argument('--oodsets', '--wim-sets', nargs='*', default=None)
    p.add_argument('--batch-size', type=int, default=64)
    p.add_argument('--test-batch-size', type=int, default=256)
    p.add_argument('--inspection', action='store_true',
                   help='record encoder-mean SampleRecorders per set before '
                        'and after the fine-tune for PCA/t-SNE/latent-shift '
                        'analysis (ref ft/__main__.py:209-221)')
    p.add_argument('--pca', action='store_const', dest='inspection_model',
                   const='pca', default='pca',
                   help='project latents with PCA (ref ft/inspection.py:217)')
    p.add_argument('--tsne', action='store_const', dest='inspection_model',
                   const='tsne',
                   help='project latents with t-SNE '
                        '(ref ft/inspection.py:218)')
    p.add_argument('--inspection-model', choices=['pca', 'tsne'],
                   dest='inspection_model')
    p.add_argument('--lr', type=float, default=None,
                   help='fine-tune with a fresh adam at this lr instead of '
                        "the source job's optimizer (ref ft/__main__.py:194)")
    p.add_argument('--weight-decay', type=float, default=None)
    p.add_argument('--seed', '-S', '--sampling-seed', type=int, default=None,
                   help='sampling seed (default: source job number + 7, '
                        'ref ft/__main__.py:160-161)')
    p.add_argument('--task', '-T', '--sampling-task', type=int, default=0,
                   help='array task index')
    p.add_argument('--sampling-task-shift', type=int, default=0,
                   help='added to --task (SLURM offset arrays, '
                        'ref ft/__main__.py:87)')
    p.add_argument('--array', '-A', '--array-job-dir', default=None,
                   help='array dir (aggregation)')
    p.add_argument('--do-not-collect-jobs', action='store_false',
                   dest='collect_jobs',
                   help='(accepted for reference compatibility; array '
                        'registration is explicit via --register here)')
    p.add_argument('--register', nargs='*', default=[],
                   help='job dirs to register into --array')
    p.add_argument('--poscod', action='store_true',
                   help='train a frozen-net 1-logit OOD head instead of WIM '
                        '(ref ft/poscod.py)')
    p.add_argument('-v', '--verbose', action='count', default=0)
    p.add_argument('--debug', action='store_true')
    add_mesh_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.args_from_file:
        # the INDEX-th line of FILE replaces the CLI (ref ft/__main__.py:91-95)
        path, idx = args.args_from_file
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()
                     and not ln.lstrip().startswith('#')]
        line = lines[int(idx)]
        logging.info('Args from file: %s', line)
        args = p.parse_args(line.split(), namespace=args)
    args.task += args.sampling_task_shift
    refuse_unported(args)
    args.mesh_obj = mesh_from_args(args)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)
    if args.seed is None:
        # ref ft/__main__.py:160-161: sampling seed defaults to job# + 7
        args.seed = (args.job or 0) + 7

    try:
        defaults = load_config_section(args.config_file, args.config)
    except ValueError:
        defaults = {}

    def dflt(name, fallback):
        v = getattr(args, name.replace('-', '_'), None)
        if v is not None:
            return v
        return defaults.get(name.replace('-', '_'), fallback)

    if args.array:
        return _array_main(args)
    return _job_main(args, dflt)


def _report_latent_shift(save_dir: str, epoch: int, set_name: str,
                         classes=None, model: str = 'pca') -> None:
    """Shift metrics + 2D projection (PCA or t-SNE) between the init and
    post latent dumps; writes inspection.json and proj2d-<model>.csv next
    to the recorders (ref ft/inspection.py:24-180)."""
    edir = os.path.join(save_dir, 'samples', '{:04d}'.format(epoch))

    # all recorded sets feed the 2D projection (ref proj2d); loaded once,
    # the shift metrics reuse the same arrays
    def _load_dir(d):
        recs = {}
        for f in sorted(os.listdir(d)) if os.path.isdir(d) else []:
            if f.startswith('sample-') and f.endswith('.npz'):
                r = SampleRecorder.load(os.path.join(d, f))
                recs[f[len('sample-'):-len('.npz')]] = {
                    k: r.get(k) for k in r.keys()}
        return recs
    pre_recs = _load_dir(os.path.join(edir, 'init'))
    post_recs = _load_dir(edir)
    if not (set_name in pre_recs and set_name in post_recs):
        return
    mu0 = pre_recs[set_name]['mu']
    mu1 = post_recs[set_name]['mu']
    n = min(len(mu0), len(mu1))
    shift = latent_shift(mu0[:n], mu1[:n])
    _, _, var_ratio = latent_pca(mu1[:n])
    out = dict(shift, set=set_name, epoch=epoch, model=model,
               pca_explained=[float(v) for v in np.asarray(var_ratio)[:2]])
    with open(os.path.join(edir, 'inspection.json'), 'w') as f:
        json.dump(out, f, indent=1)
    logging.info('latent shift (%s): %s', set_name, shift)

    csv = os.path.join(edir, 'proj2d-{}.csv'.format(model))
    proj2d_csv(pre_recs, post_recs, set_name,
               classes if classes is not None
               else list(range(len(pre_recs[set_name]['centroids']))),
               csv, model=model)
    logging.info('2d latent projection (%s) written to %s', model, csv)


def _array_main(args):
    arr = WIMArray(args.array)
    if args.register:
        arr.register_jobs(*args.register)
    jobs = arr.registered_jobs()
    if not jobs:
        sys.exit('array has no registered jobs')
    wim = load_wim_job(jobs[0], device=args.device)
    testset_name = wim.job.training_parameters.get('set')
    oods = args.oodsets or get_same_size_by_name(testset_name)
    arr.recompute_rates(wim, testset_name, oods)
    print('array rates written to {}/ood.json'.format(args.array))
    return 0


def _job_main(args, dflt):
    if args.job is None:
        sys.exit('job number required (or --array)')
    job = find_by_job_number(args.job_dir, args.job, device=args.device,
                             strict=False)
    if job is None:
        sys.exit('job {} not found'.format(args.job))
    # the fine-tuned model is a NEW job with its own number under
    # wim-job-dir (ref ft/__main__.py:113-206) — never save back into the
    # source job's directory (that would overwrite the trained baseline's
    # checkpoint and ood.json)
    wim_root = args.wim_job_dir or os.path.join(args.job_dir, 'wim')
    source_number = job.job_number
    # rank 0 draws the number (the counter file is shared)
    job.job_number = args.job_number or broadcast_object(
        next_job_number(args.job_dir) if is_write_process() else None)
    job.training_parameters['from_job'] = source_number
    job.saved_dir = save_dir_for(job, wim_root,
                                 job.model_cfg.latent_sampling)
    logging.info('wim job %d (from job %d) -> %s',
                 job.job_number, source_number, job.saved_dir)
    job.ood_results = {}
    if args.lr is not None or args.weight_decay is not None:
        # a fresh adam for the fine-tune (ref ft/__main__.py:194-196);
        # finetune() re-inits the optimizer state from job.opt_cfg
        job.opt_cfg = dataclasses.replace(
            job.opt_cfg, optim_type='adam',
            lr=args.lr if args.lr is not None else job.opt_cfg.lr,
            weight_decay=(args.weight_decay if args.weight_decay is not None
                          else job.opt_cfg.weight_decay))

    if args.poscod:
        return _run_poscod(args, job, dflt)

    wim = WIMJob(job=job)
    prior_kw = {'distribution': dflt('wim-prior', 'gaussian'),
                'init_mean': dflt('wim-mean', 8.0), 'num_priors': 1}
    if prior_kw['distribution'] in ('tilted', 'uniform'):
        prior_kw['tau'] = dflt('wim-tau', 25.0)
        prior_kw.pop('init_mean')
    # the seed draws the prior and rides in ft_params (ref wim.json carries
    # it too, ft/__main__.py:171), so the prior is re-derivable even
    # without wim_prior.npz
    prior_kw['seed'] = args.seed
    wim.set_alternate_prior(**prior_kw)

    dataset = job.training_parameters.get('set')
    trainset, testset = get_dataset(dataset)
    ood_names = args.oodsets if args.oodsets is not None else \
        [n for n in get_same_size_by_name(dataset) if not n.endswith('90')][:2]
    oodsets = [get_dataset(n, splits=['test'])[1] for n in ood_names]

    moving = create_moving_set(
        dataset, moving_size=int(dflt('moving-size', 512)),
        ood_mix=float(dflt('mix', 0.5)), oodsets=ood_names,
        padding_sets=args.padding_sets, padding=args.padding,
        mix_padding=args.mix_padding, seed=args.seed, task=args.task)

    mesh = args.mesh_obj
    inspect_sets = [testset] + list(oodsets)
    if args.inspection and job.saved_dir:
        record_latents(wim, inspect_sets, args.test_batch_size,
                       make_generator(job.device, args.seed),
                       os.path.join(job.saved_dir, 'samples',
                                    '{:04d}'.format(job.trained), 'init'),
                       mesh=mesh)

    outputs = EpochOutput(stdout=is_write_process())
    if job.saved_dir and is_write_process():
        # add_file creates the parent directory itself
        outputs.add_file(os.path.join(job.saved_dir, 'output.out'))

    try:
        with Scheduler(seed=args.seed, task=args.task):
            finetune(wim, trainset, moving, testset, oodsets,
                     epochs=int(dflt('epochs', 1)),
                     alpha=float(dflt('alpha', 0.1)),
                     train_size=int(dflt('train-size', 100000)),
                     batch_size=args.batch_size,
                     test_batch_size=args.test_batch_size,
                     save_dir=job.saved_dir, seed=args.seed, mesh=mesh,
                     outputs=outputs)
    finally:
        outputs.close()
    # moving-set composition into the persisted wim params so the flat
    # dict's wim_sets/wim_mix/wim_padding filters resolve (ref filters.ini
    # wim_* keys; dictify reads tp['wim'])
    job.training_parameters.setdefault('wim', {}).update(
        sets=list(ood_names), mix=float(dflt('mix', 0.5)),
        padding=args.padding, mix_padding=args.mix_padding,
        padding_dataset='-'.join(args.padding_sets) or None)
    if job.saved_dir:
        save_job(job, job.saved_dir, save_state=False)
    logging.info('wim results: %s', job.ood_results.get(job.trained, {}))

    if args.inspection and job.saved_dir:
        record_latents(wim, inspect_sets, args.test_batch_size,
                       make_generator(job.device, args.seed),
                       os.path.join(job.saved_dir, 'samples',
                                    '{:04d}'.format(job.trained)),
                       mesh=mesh)
        if is_write_process():
            _report_latent_shift(job.saved_dir, job.trained, testset.name,
                                 classes=getattr(testset, 'classes', None),
                                 model=args.inspection_model)
    return 0


if __name__ == '__main__':
    sys.exit(main())
