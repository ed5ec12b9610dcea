"""Ensemble CLI (ref module/aggregation.py __main__ + results/aggregation.py),
on the CUDA card unless ``--device cpu``.

    python -m joint_vae_tpu_torch.cli.aggregate <job> <job> ... --job-dir jobs \
        [--methods elbo joint mean vote] [--combos 1 2] [--record] [--no-ood]

Port of ``joint_vae_tpu/cli/aggregate.py``.  Loads the jobs, evaluates
the shared test set once per model, combines the per-class scores into
ensemble posteriors, and prints accuracy (and OOD AUROC) per combination
method, plus the pairwise latent mutual information matrix; ``--record``
writes per-sample Im-<T> tensors for ``results.mutual_info``.  Batch i of
a pass draws its noise from ``fold_in(0, i)`` (the OOD passes from
``fold_in(0, 9)``, the records from ``fold_in(0, 31 + i)``); on the card
each scored batch replays a CUDA graph held on its job, its generator
reseeded per batch.
"""

import argparse
import itertools
import logging
import os
import sys
import weakref
from typing import Optional

import numpy as np
import torch

from ..data.loaders import DataLoader, get_dataset
from ..device import to_device
from ..evals.aggregation import (compute_latent_mutual_info, ensemble_posterior,
                                 ensemble_predict, latent_mutual_info_tensors)
from ..models.evaluate import evaluate
from ..ops.roc import auroc_one_sided_exact
from ..save_load.fetch import find_by_job_number
from ..save_load.recorders import LossRecorder, record_filename
from ..train.graphs import ScoreGraph, held_graph
from ..train.state import fold_in
from . import add_device_arg

SEED = 0


def _score_graph(job, graphed: bool = True) -> ScoreGraph:
    """``_scores``' batch (the JAX CLI's jitted ``f``): the per-class
    scores, the neg-kl scores and the posteriors, as a scoring graph
    (``graphed=False``: eager)."""
    ref = weakref.ref(job)          # the job holds the graph

    def body(generator, x):
        job = ref()
        out = evaluate(job.model, x, None, sigma_state=job.sigma_state,
                       train=False, generator=generator)
        losses = out.losses
        s = losses.get('iws')
        if s is None or s.ndim < 2:
            s = -losses['total']
        kl = losses.get('kl')
        return {'s': s, 'kl': (kl if kl is not None and kl.ndim >= 2
                               else losses['total']),
                'post': torch.softmax(out.logits, -1)}
    return ScoreGraph(body, name='aggregate_batch', graphed=graphed)


def _scores(job, dataset, batch_size, seed, score='total',
            graphed: Optional[bool] = None):
    """(C, N) per-class scores + true labels + posteriors + neg-kl scores
    (the 'mean~' combine input, ref results/aggregation.py:330-335).  On
    the card each batch replays a scoring graph held on the job
    (``graphed=False``: eager); its outputs stay there until the set's
    end."""
    graph, gen = held_graph(job, 'aggregate',
                            lambda g: _score_graph(job, g), graphed=graphed)
    per, ys, posts, kls = [], [], [], []
    for i, (x, y) in enumerate(DataLoader(dataset, batch_size, shuffle=False)):
        out = graph(gen.manual_seed(fold_in(seed, i)),
                    x=to_device(x, job.device))
        per.append(out['s'])
        kls.append(out['kl'])
        posts.append(out['post'])
        ys.append(y)
    return (torch.cat(per, -1).cpu().numpy(), np.concatenate(ys),
            np.ascontiguousarray(torch.cat(posts).cpu().numpy().T),
            -torch.cat(kls, -1).cpu().numpy())


def main(argv=None):
    p = argparse.ArgumentParser(prog='jvt-aggregate')
    p.add_argument('jobs', nargs='+', type=int)
    p.add_argument('--job-dir', default='jobs')
    p.add_argument('--methods', nargs='*',
                   default=['elbo', 'joint', 'mean', 'vote'])
    p.add_argument('--combos', nargs='*', type=int, default=None,
                   help='evaluate every k-of-n sub-ensemble for each given '
                        'k (ref results/aggregation.py:241-308); prints one '
                        'accuracy row per (combo, method)')
    p.add_argument('--sets-to-exclude', nargs='*', default=[],
                   help='OOD companions to skip in --ood/--record '
                        '(ref results/aggregation.py:33)')
    p.add_argument('--ood', action='store_true', default=True,
                   help='(on by default, like the reference)')
    p.add_argument('--no-ood', action='store_false', dest='ood',
                   help='skip the ensemble OOD pass (ref aggregation.py:135)')
    p.add_argument('--batch-size', '-M', type=int, default=256)
    p.add_argument('--dataset-size', '-N', type=int, default=None)
    p.add_argument('--record', action='store_true',
                   help='record per-sample Im-{T} tensors per set into '
                        '<job-dir>/<set>/<j1|j2>/record-<set>.npz '
                        '(ref module/aggregation.py:219; consumed by '
                        'results.mutual_info)')
    p.add_argument('-T', '--temps', nargs='*', type=float,
                   default=[1.0, 2.0, 5.0])
    p.add_argument('-v', '--verbose', action='count', default=0)
    p.add_argument('--debug', action='store_true')
    add_device_arg(p)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)

    jobs = []
    for n in args.jobs:
        j = find_by_job_number(args.job_dir, n, device=args.device)
        if j is None:
            sys.exit('job {} not found'.format(n))
        jobs.append(j)
    name = jobs[0].training_parameters.get('set')
    _, testset = get_dataset(name, splits=['test'], size=args.dataset_size)

    all_scores, all_posts, all_nkl = [], [], []
    y = None
    for j in jobs:
        s, y, post, nkl = _scores(j, testset, args.batch_size, SEED)
        all_scores.append(s)
        all_posts.append(post)
        all_nkl.append(nkl)
        acc = (s.argmax(0) == y).mean()
        print('job {:>6}: accuracy {:.2%}'.format(j.job_number, acc))

    def _inputs(m, idx, scores=all_scores, nkl=all_nkl):
        """combine inputs for method m over the models at idx — the one
        place that knows each method's score source and sign"""
        if m == 'joint':
            return [-scores[i] for i in idx]
        if m == 'mean~':
            return [nkl[i] for i in idx]
        return [scores[i] for i in idx]

    everyone = list(range(len(jobs)))
    for m in args.methods:
        pred = ensemble_predict(_inputs(m, everyone), m)
        print('ensemble {:>6}: accuracy {:.2%}'.format(m, (pred == y).mean()))

    if args.combos:
        # every k-of-n sub-ensemble (ref results/aggregation.py:241-308);
        # combo named with the reference's agg-type letters (:18); elbo/
        # lme/iws are not reference combo types — each gets its own join
        # char (none of the reference's) so no two methods' rows share a
        # name
        letter = {'vote': '&', 'joint': ',', 'mean': '+', 'mean~': '~',
                  'elbo': '|', 'lme': '/', 'iws': '^'}
        for k in sorted(set(args.combos)):
            if not 1 <= k <= len(jobs):
                continue
            for idx in itertools.combinations(everyone, k):
                for m in (args.methods if k > 1 else ['mean']):
                    pred = ensemble_predict(_inputs(m, list(idx)), m)
                    cname = letter.get(m, '+').join(
                        str(jobs[i].job_number) for i in idx)
                    print('combo {:>14}: accuracy {:.2%}'.format(
                        cname, (pred == y).mean()))

    print('\nlatent mutual information (nats):')
    for i in range(len(jobs)):
        row = ['{:.3f}'.format(compute_latent_mutual_info(all_posts[i],
                                                          all_posts[k]))
               for k in range(len(jobs))]
        print('  job {:>6}: {}'.format(jobs[i].job_number, ' '.join(row)))

    if args.record:
        if len(jobs) != 2:
            sys.exit('--record needs exactly two jobs')
        out_dir = os.path.join(
            args.job_dir, name,
            '|'.join(str(n) for n in sorted(args.jobs)))
        os.makedirs(out_dir, exist_ok=True)
        sets = [testset]
        if args.ood:
            for ood_name in testset.same_size:
                if ood_name in args.sets_to_exclude:
                    continue
                try:
                    _, s = get_dataset(ood_name, splits=['test'],
                                       size=args.dataset_size)
                    sets.append(s)
                except (ValueError, FileNotFoundError):
                    continue
        for s in sets:
            rec = LossRecorder(args.batch_size)
            for i, (x, yb) in enumerate(DataLoader(s, args.batch_size,
                                                   shuffle=False)):
                Im, y_hat = latent_mutual_info_tensors(
                    jobs[0], jobs[1], x, temps=args.temps,
                    seed=fold_in(SEED, 31 + i))
                rec.append_batch(
                    **{'Im-{:g}'.format(T): v for T, v in Im.items()},
                    y_=y_hat, y_true=np.asarray(yb))
            path = os.path.join(out_dir, record_filename(s.name))
            rec.save(path)
            print('recorded Im tensors for {} -> {}'.format(s.name, path))

    if args.ood:
        names = [n for n in testset.same_size
                 if n not in args.sets_to_exclude][:3]
        for ood_name in names:
            try:
                _, ood = get_dataset(ood_name, splits=['test'],
                                     size=args.dataset_size)
            except (ValueError, FileNotFoundError):
                continue
            per = [_scores(j, ood, args.batch_size, fold_in(SEED, 9))
                   for j in jobs]
            ood_scores = [q[0] for q in per]
            ood_nkl = [q[3] for q in per]
            for m in args.methods:
                pi = ensemble_posterior(_inputs(m, everyone), m).max(0)
                po = ensemble_posterior(
                    _inputs(m, everyone, ood_scores, ood_nkl), m).max(0)
                auc = float(auroc_one_sided_exact(torch.from_numpy(pi),
                                                  torch.from_numpy(po)))
                print('ood {} {}: auroc {:.2%}'.format(ood_name, m, auc))
    return 0


if __name__ == '__main__':
    sys.exit(main())
