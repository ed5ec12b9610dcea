#!/usr/bin/env python
"""One-shot reproduction of the reference's headline OOD table with the
PyTorch port, as ``scripts/reproduce_sota.py`` does for the JAX package.

The reference's flagship claim (ref results/tabs/sota.csv:1-5) is a
CIFAR-10 tilted-prior VAE (ref config.ini [tilted]: conv32 features, K=100,
tau=25, sigma=0.7071) WIM-fine-tuned once per OOD set
(ref results/tabs/wim/wim-vae.ini: moving 512, train 20000, mix 0.5), scored
against LSUN-R and SVHN.  This script runs that whole pipeline end-to-end
on the CUDA card (``--device cpu`` for the CPU) and emits the wim-vae AUC /
FPR@TPR95 numbers beside the published row.

Real-data run (needs CIFAR-10, SVHN and LSUN-R on disk):

    JVT_DATA_DIR=/path/to/data python scripts/torch_reproduce_sota.py \\
        --out results/sota

with the standard on-disk layouts under $JVT_DATA_DIR (cifar10 python-pickle
batches, svhn/*_32x32.mat, exported lsun/*_test folders — see
scripts/torch_prepare_data.py).  Missing real files fail loudly
(require_real); nothing silently degrades to synthetic data.

Fixture mode (tiny synthetic files in the real on-disk formats, tiny
model — exercises every pipeline stage including the real readers):

    python scripts/torch_reproduce_sota.py --fixtures /tmp/fx --out /tmp/sota
"""

import argparse
import csv
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the published row (ref results/tabs/sota.csv:5): ratio = Likelihood Ratios,
# regret = Likelihood Regret (literature baselines quoted by the reference),
# wim-vae = the reference's own headline method.  AUC percent.
PUBLISHED = {'lsunr': {'ratio': 50.8, 'regret': 60.6, 'wim-vae': 94.1},
             'svhn': {'ratio': 40.4, 'regret': 73.8, 'wim-vae': 99.1}}
METHODS = ['elbo', 'elbo@', 'zdist', 'zdist@', 'kl']


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--out', default='results/sota')
    p.add_argument('--sets', nargs='*', default=['lsunr', 'svhn'])
    p.add_argument('--epochs', type=int, default=None,
                   help='pretrain epochs (default: the [tilted] config, 250)')
    p.add_argument('--wim-epochs', type=int, default=1)
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--test-batch-size', type=int, default=512)
    # WIM operating point: ref results/tabs/wim/wim-vae.ini
    p.add_argument('--alpha', type=float, default=0.2)
    p.add_argument('--mix', type=float, default=0.5)
    p.add_argument('--train-size', type=int, default=20000)
    p.add_argument('--moving-size', type=int, default=512)
    p.add_argument('--wim-mean', type=float, default=10.0)
    p.add_argument('--headline', default='zdist',
                   help='method reported in the wim-vae column '
                        '(ref wim-vae.ini ood_method = zdist)')
    p.add_argument('--from', dest='from_dir', default=None,
                   help='resume from a saved pretrained job dir '
                        '(skip pretraining)')
    p.add_argument('--dataset-size', type=int, default=None)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--fixtures', default=None, metavar='DIR',
                   help='CI mode: write tiny fixture datasets in the real '
                        'file formats under DIR and shrink the model/run')
    p.add_argument('--config-file', default=None,
                   help='INI with the [tilted] section '
                        '(default: configs/default.ini; the reference '
                        'config.ini works verbatim)')
    p.add_argument('--device', default=None,
                   help="default the CUDA card; 'cpu' for the CPU")
    p.add_argument('--dtype', default='float32',
                   choices=['float32', 'bfloat16'], help='compute dtype')
    return p


def table_rows(sets, results: dict, headline: str) -> list:
    """The rows of ``sota_native.csv``: three header rows, the published
    row and this run's (its wim-vae cells from ``headline``)."""
    hdr_sets, hdr_methods, hdr_meas = ['set'], ['method'], ['measures']
    pub_row, our_row = ['vae (published)'], ['vae (this run)']
    for name in sets:
        for meth in ('ratio', 'regret', 'wim-vae'):
            hdr_sets += [name, name]
            hdr_methods += [meth, meth]
            hdr_meas += ['auc', 'fpr']
            pub = PUBLISHED.get(name, {}).get(meth)
            pub_row += ['' if pub is None else pub, '']
            if meth == 'wim-vae':
                r = results[name].get(headline, {})
                our_row += [round(r.get('auc', float('nan')), 1),
                            round(r.get('fpr95', float('nan')), 1)]
            else:
                our_row += ['', '']   # literature methods, not reimplemented
    return [hdr_sets, hdr_methods, hdr_meas, pub_row, our_row]


def main(argv=None):
    args = build_argparser().parse_args(argv)
    t0 = time.time()

    import torch
    from scripts.torch_evidence import card
    from joint_vae_tpu_torch.data import loaders
    from joint_vae_tpu_torch.evals.engines import ood_detection_rates
    from joint_vae_tpu_torch.ft.datasets import MixtureDataset
    from joint_vae_tpu_torch.ft.job import finetune
    from joint_vae_tpu_torch.ft.wim import WIMJob
    from joint_vae_tpu_torch.save_load.jobs import load_job, new_job, save_job
    from joint_vae_tpu_torch.train.trainer import train_model
    from joint_vae_tpu_torch.utils.parameters import (
        get_args, model_config_from_args, optimizer_config_from_args)
    from joint_vae_tpu_torch.utils.print_log import EpochOutput

    if args.device is None and not torch.cuda.is_available():
        raise SystemExit('no CUDA card: pass --device cpu')
    fixture_overrides = []
    if args.fixtures:
        from scripts.torch_prepare_data import cmd_make_fixtures
        os.makedirs(args.fixtures, exist_ok=True)
        cmd_make_fixtures(argparse.Namespace(data_dir=args.fixtures))
        os.environ['JVT_DATA_DIR'] = args.fixtures
        loaders.DATA_DIR = args.fixtures
        loaders._cache.clear()
        # tiny model + run: every stage still executes for real
        fixture_overrides = ['--latent-dim', '8', '--encoder', '32',
                             '--decoder', '32', '--test-latent-sampling', '2']
        args.epochs = args.epochs or 1
        args.batch_size = args.batch_size or 8
        args.test_batch_size = min(args.test_batch_size, 8)
        args.train_size = min(args.train_size, 32)
        args.moving_size = min(args.moving_size, 16)

    os.makedirs(args.out, exist_ok=True)

    cli = ['--config', 'tilted']
    if args.config_file:
        cli += ['--config-file', args.config_file]
    cli += fixture_overrides + ['--compute-dtype', args.dtype]
    targs = get_args(cli)

    # ---- datasets (fail loudly if the real files are absent) --------------
    tr, te = loaders.get_dataset('cifar10', transformer=targs.transformer,
                                 size=args.dataset_size, require_real=True)
    oods = {}
    for name in args.sets:
        _, s = loaders.get_dataset(name, transformer=targs.transformer,
                                   splits=['test'],
                                   size=args.dataset_size, require_real=True)
        oods[name] = s
    pretrain_s = None
    if args.from_dir:
        job = load_job(args.from_dir, device=args.device)
        pre_dir = args.from_dir
    else:
        job = new_job(model_config_from_args(targs),
                      optimizer_config_from_args(targs), seed=args.seed,
                      device=args.device)
        job.training_parameters.update({'set': 'cifar10',
                                        'transformer': targs.transformer})
        epochs = args.epochs if args.epochs is not None else targs.epochs
        bs = args.batch_size or targs.batch_size
        print('[sota] pretraining [tilted] VAE: {} epochs, batch {}'
              .format(epochs, bs), flush=True)
        t1 = time.time()
        train_model(job, tr, te, [], epochs=epochs, batch_size=bs,
                    test_batch_size=args.test_batch_size,
                    final_test=False, final_ood=False,
                    outputs=EpochOutput(stdout=False), seed=args.seed)
        pretrain_s = time.time() - t1
        pre_dir = os.path.join(args.out, 'pretrained')
        save_job(job, pre_dir)
    print('[sota] pretrained ({:.0f}s), base-job OOD baseline:'
          .format(time.time() - t0), flush=True)
    pre = ood_detection_rates(job, te, list(oods.values()),
                              batch_size=args.test_batch_size,
                              method=['elbo', 'zdist', 'kl', 'iws'],
                              update_self_ood=False, recording=False)
    for s, ms in pre.items():
        print('   {}: {}'.format(
            s, {m: round(100 * v['auc'], 1) for m, v in ms.items()}),
            flush=True)

    # ---- one WIM fine-tune per OOD set (ref wim-tilted.ini sections) ------
    results, wim_s = {}, {}
    for name, ood in oods.items():
        jb = load_job(pre_dir, device=args.device)
        wim = WIMJob(job=jb)
        wim.set_alternate_prior(init_mean=args.wim_mean, num_priors=1,
                                seed=7)
        moving = MixtureDataset(mix={'ood': args.mix, 'ind': 1 - args.mix},
                                length=args.moving_size, ood=ood, ind=te)
        print('[sota] WIM fine-tune vs {} (alpha={}, moving={}, train={})'
              .format(name, args.alpha, args.moving_size, args.train_size),
              flush=True)
        t1 = time.time()
        finetune(wim, tr, moving, te, [ood], epochs=args.wim_epochs,
                 alpha=args.alpha, train_size=args.train_size,
                 batch_size=args.batch_size or 64,
                 test_batch_size=args.test_batch_size,
                 ood_methods=METHODS, seed=args.seed,
                 save_dir=os.path.join(args.out, 'wim-' + name),
                 outputs=EpochOutput(stdout=False))
        wim_s[name] = time.time() - t1
        per = jb.ood_results[jb.trained][name]
        results[name] = {
            m: {'auc': 100 * v['auc'],
                'fpr95': 100 * v['fpr'][v['tpr'].index(0.95)]}
            for m, v in per.items() if m in METHODS}
        print('   {}: {}'.format(name, {
            m: round(r['auc'], 1) for m, r in results[name].items()}),
            flush=True)

    # ---- emit the table ----------------------------------------------------
    csv_path = os.path.join(args.out, 'sota_native.csv')
    with open(csv_path, 'w', newline='') as f:
        w = csv.writer(f)
        for row in table_rows(args.sets, results, args.headline):
            w.writerow(row)

    report = {'config': 'tilted', 'headline': args.headline,
              'epochs': args.epochs, 'wim_epochs': args.wim_epochs,
              'alpha': args.alpha, 'mix': args.mix,
              'train_size': args.train_size, 'moving_size': args.moving_size,
              'pre_auroc': {s: {m: round(100 * v['auc'], 2)
                                for m, v in ms.items()}
                            for s, ms in pre.items()},
              'post': {s: {m: {k: round(x, 2) for k, x in r.items()}
                           for m, r in ms.items()}
                       for s, ms in results.items()},
              'published': PUBLISHED, 'seconds': round(time.time() - t0, 1),
              'pretrain_seconds': pretrain_s, 'wim_seconds': wim_s,
              'compute_dtype': args.dtype,
              **(card() if job.device.type == 'cuda' else {'device': 'cpu'}),
              'torch': torch.__version__, 'cuda': torch.version.cuda}
    with open(os.path.join(args.out, 'sota_native.json'), 'w') as f:
        json.dump(report, f, indent=1)
    with open(csv_path) as f:
        print(f.read())
    print(json.dumps({k: report[k] for k in ('post', 'seconds')}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
