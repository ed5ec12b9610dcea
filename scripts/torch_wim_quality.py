#!/usr/bin/env python
"""WIM quality run of the PyTorch port: pretrain a plain VAE, then run
the WIM alternate-prior flow against a moving set of OOD images and
compare the OOD AUROC before and after tuning, as
``scripts/wim_quality.py`` does for the JAX package (the same
configuration, optimizer, epochs, alternate prior, alpha, sets and
methods).

The default sets are the ones ``docs/WIM_QUALITY.json`` was taken on:
shapes32 without shape classes 8 and 9 in distribution, those two classes
(``shapes32+8+9``) as the near-OOD set and the moving set's source.  The
default operating point is the JAX script's (alpha 0.3, one fine-tune
epoch, a pure-OOD moving set); ``scripts/wim_inversion_study.py:17-18``
records that the JAX record itself was measured at the strong dose, alpha
1.0 and 8 fine-tune epochs: ``--alpha 1.0 --ft-epochs 8``.  A run away
from the default point is kept under ``<dtype> alpha=.. ft_epochs=..
mix=..``.

    python scripts/torch_wim_quality.py                  # float32, bfloat16
    python scripts/torch_wim_quality.py --dtype bfloat16
    python scripts/torch_wim_quality.py --alpha 1.0 --ft-epochs 8
    python scripts/torch_wim_quality.py --device cpu --epochs 1 \\
        --train-size 1024 --test-size 256 --ft-size 512 \\
        --out /tmp/wq.json                               # a rehearsal

Each dtype's record goes under its name into
``docs/WIM_QUALITY_TORCH.json`` (a CPU run writes only where ``--out``
says): the JAX record's keys (``pre_auroc``, ``post_auroc`` per set and
method, ...), the seconds, images/s and launches of pretraining, of the
pre-tuning evaluation and of the fine-tune, and the band (``BAND``) with
whether it was met.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.torch_evidence import (Stopwatch, aurocs, best, cut, parser,
                                    pretrain, run_dtypes, timed_finetune,
                                    vae_config)

from joint_vae_tpu_torch.data.loaders import get_dataset
from joint_vae_tpu_torch.evals.engines import ood_detection_rates
from joint_vae_tpu_torch.ft.datasets import MixtureDataset
from joint_vae_tpu_torch.ft.job import finetune
from joint_vae_tpu_torch.ft.wim import WIMJob
from joint_vae_tpu_torch.save_load.jobs import new_job
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig

PRE_METHODS = ['elbo', 'iws', 'zdist', 'kl']
POST_METHODS = ['elbo', 'elbo@', 'zdist', 'zdist@', 'kl']
ALTERNATE = dict(init_mean=6.0, num_priors=1, seed=7)
MOVING_SIZE, FT_BATCH, TEST_BATCH = 512, 128, 512
# the band, fixed before the first run on the card against the JAX
# record (docs/WIM_QUALITY.json: best AUROC 0.5141 before tuning, 0.9939
# after): over the OOD sets, the best pre-tuning AUROC at most
# pre_best_max, the best post-tuning one at least post_best_min, and
# their difference at least gain_min
BAND = {'pre_best_max': 0.70, 'post_best_min': 0.95, 'gain_min': 0.25}
# (alpha, fine-tune epochs, mix) of the JAX script's defaults
DEFAULT_POINT = (0.3, 1, 1.0)


def config(dtype: str):
    return vae_config(dtype, num_labels=10)


def tune_and_score(job, trainset, testset, oodsets, moving, *, alpha: float,
                   ft_epochs: int, ft_size: int, alternate=None,
                   batch_size: int = FT_BATCH,
                   test_batch_size: int = TEST_BATCH, seed: int = 0) -> dict:
    """The JAX script's flow after pretraining (``wim_quality.py:51-73``):
    the OOD baseline on the original prior, the alternate prior
    (``ALTERNATE``; ``alternate``: its arrays, e.g. the JAX package's),
    one WIM fine-tune against ``moving``, the post-tuning OOD results;
    ``seed`` added to the prior's and the fine-tune's seeds.  Returns
    {'pre', 'post', 'pre_eval', 'finetune'}."""
    with Stopwatch(job.device) as sw:
        pre = ood_detection_rates(job, testset, oodsets,
                                  batch_size=test_batch_size,
                                  method=PRE_METHODS, update_self_ood=False,
                                  recording=False)
    wim = WIMJob(job=job)
    wim.set_alternate_prior(**dict(ALTERNATE,
                                   seed=ALTERNATE['seed'] + seed))
    if alternate is not None:
        wim.set_alternate_prior_arrays(alternate)
    ft = timed_finetune(finetune, wim, trainset, moving, testset, oodsets,
                        epochs=ft_epochs, alpha=alpha, train_size=ft_size,
                        batch_size=batch_size,
                        test_batch_size=test_batch_size,
                        ood_methods=POST_METHODS, seed=seed)
    return {'pre': pre, 'post': job.ood_results[job.trained],
            'pre_eval': {'seconds': sw.seconds, 'launches': sw.launches,
                         'batches_run': sw.batches_run},
            'finetune': ft}


def band_met(pre_best: dict, post_best: dict) -> dict:
    pre = max(a for a, _ in pre_best.values())
    post = max(a for a, _ in post_best.values())
    return {'pre_best_max': pre <= BAND['pre_best_max'],
            'post_best_min': post >= BAND['post_best_min'],
            'gain_min': post - pre >= BAND['gain_min']}


def run(dtype: str, args) -> dict:
    tr, test = get_dataset(args.ind)
    tr, te = cut(tr, args.train_size), cut(test, args.test_size)
    # one evaluation per set: the JAX script passes its one set twice
    names = list(dict.fromkeys(args.ood))
    full = [get_dataset(n, splits=['test'], size=4000)[1] for n in names]
    oods = [cut(d, args.test_size) for d in full]
    job = new_job(config(dtype), OptimizerConfig(lr=3e-4), seed=args.seed,
                  device=args.device)
    job.training_parameters['set'] = args.ind
    pt = pretrain(job, tr, args.epochs)
    # the moving set from the whole sets (a cut only shrinks evaluation)
    moving = MixtureDataset(mix={'ood': args.mix, 'ind': 1.0 - args.mix},
                            length=MOVING_SIZE, ood=full[0], ind=test)
    out = tune_and_score(job, tr, te, oods, moving, alpha=args.alpha,
                         ft_epochs=args.ft_epochs, ft_size=args.ft_size,
                         seed=args.seed)
    pre_best, post_best = best(out['pre']), best(out['post'])
    print('pre :', pre_best, '\npost:', post_best, flush=True)
    return {
        'dataset': '{} vae (beta=0.05), ood={}'.format(args.ind, names),
        'epochs': args.epochs,
        'pre_auroc': aurocs(out['pre']), 'post_auroc': aurocs(out['post']),
        'pre_best': {s: {'auc': a, 'method': m}
                     for s, (a, m) in pre_best.items()},
        'post_best': {s: {'auc': a, 'method': m}
                      for s, (a, m) in post_best.items()},
        'alpha': args.alpha, 'mix': args.mix, 'ft_epochs': args.ft_epochs,
        'train_images': len(tr), 'test_images': len(te),
        'ood_images': {d.name: len(d) for d in oods},
        'pretrain': pt, 'pre_eval': out['pre_eval'],
        'finetune': out['finetune'],
        'band': BAND, 'band_met': band_met(pre_best, post_best)}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument('--ind', default='shapes32-8-9')
    p.add_argument('--ood', nargs='+', default=['shapes32+8+9'])
    p.add_argument('--alpha', type=float, default=0.3)
    p.add_argument('--mix', type=float, default=1.0,
                   help="the moving set's OOD share")
    args = p.parse_args(argv)
    point = (args.alpha, args.ft_epochs, args.mix)
    suffix = ('' if point == DEFAULT_POINT else
              ' alpha={} ft_epochs={} mix={}'.format(*point))
    run_dtypes(args, 'WIM_QUALITY_TORCH.json', 'scripts/torch_wim_quality.py',
               'docs/WIM_QUALITY.json (the JAX package)',
               lambda dtype: run(dtype, args), key=lambda d: d + suffix)
    return 0


if __name__ == '__main__':
    sys.exit(main())
