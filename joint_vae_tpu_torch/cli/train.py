"""Training CLI (ref train.py:18-357), on the CUDA card unless
``--device cpu``.

    python -m joint_vae_tpu_torch.cli.train --dataset cifar10 --type cvae \
        --features conv32 --upsampler deconv32 ...
    python -m joint_vae_tpu_torch.cli.train --config cifar10
    python -m joint_vae_tpu_torch.cli.train --resume <job-number>

Port of ``joint_vae_tpu/cli/train.py``.  Flow: args (config.ini-backed) ->
job number -> build or resume the job -> datasets + same-size OOD
companions from the registry -> save dir from the arch string -> sanity
forward pass -> ``train_model`` (with its test and OOD passes) under a
signal handler, the live table teed to ``<save dir>/output.out``.

On N cards, one rank each (``parallel/mesh.py``)::

    torchrun --nproc-per-node N -m joint_vae_tpu_torch.cli.train ... \
        --mesh [--model-axis 2] [--sample-axis 2]

Rank 0 draws the job number, writes the JSON files and prints the live
table; each rank writes its own chunks of the sharded checkpoint.
"""

import json
import logging
import os
import sys

import numpy as np
import torch

from ..data.loaders import get_dataset
from ..data.registry import get_same_size_by_name
from ..device import to_device
from ..models.evaluate import evaluate
from ..parallel.mesh import broadcast_object
from ..save_load.checkpoint import is_write_process
from ..save_load.dictify import _arch_string
from ..save_load.fetch import find_by_job_number
from ..save_load.jobs import mark, new_job
from ..save_load.transfer import transfer_pretrained
from ..train.optimizers import format_optimizer
from ..train.state import make_generator
from ..train.trainer import train_model
from ..utils.parameters import (get_args, model_config_from_args,
                                next_job_number, optimizer_config_from_args,
                                refuse_unported)
from ..utils.print_log import EpochOutput
from ..utils.signaling import default_handler
from . import mesh_from_args


def save_dir_for(job, job_dir: str, latent_sampling: int,
                 data_augmentation=()) -> str:
    """jobs/<set>/<arch>/<sigma=..--optim=..--sampling=..[--augment..]>/<job>
    (ref train.py:258-265)."""
    params = 'sigma={}--optim={}--sampling={}'.format(
        job.model_cfg.sigma_cfg.describe(),
        format_optimizer(job.opt_cfg, 2),
        latent_sampling)
    if data_augmentation:
        params += '--augment={}'.format('-'.join(sorted(data_augmentation)))
    return os.path.join(job_dir, job.training_parameters.get('set') or 'data',
                        _arch_string(job.model_cfg), params,
                        '{:06d}'.format(job.job_number))


def _ramp(v):
    """warmup spec -> [start, end]: [] (an empty INI line) = off."""
    if not v:
        return [0, 0]
    return list(v) if len(v) > 1 else [0, v[0]]


def main(argv=None):
    args = get_args(argv, 'train')
    logging.basicConfig(level=logging.DEBUG if args.debug else
                        logging.INFO if args.verbose else logging.WARNING)
    refuse_unported(args)
    mesh = mesh_from_args(args)
    for flag, v in (('--conv-padding', args.conv_padding),
                    ('--force-cross-y', args.force_cross_y)):
        if v:
            logging.warning('%s is accepted but (like the reference) unused',
                            flag)

    if args.resume is not None:
        job = find_by_job_number(args.job_dir, args.resume, device=args.device)
        if job is None:
            sys.exit('job {} not found under {}'.format(args.resume,
                                                        args.job_dir))
        dataset = job.training_parameters['set']
        # the job's persisted data settings win over CLI defaults on
        # resume (ref train.py:76-122 reloads the full train params): a
        # job trained with --transformer pad must not resume on
        # differently-shaped data
        saved_tf = job.training_parameters.get('transformer')
        if saved_tf and args.transformer == 'default':
            args.transformer = saved_tf
        saved_aug = job.training_parameters.get('data_augmentation')
        if saved_aug and not args.data_augmentation:
            args.data_augmentation = list(saved_aug)
        save_dir = job.saved_dir
        if args.where:                      # ref train.py:267-269
            print(save_dir)
            return 0
        mark(save_dir, 'RESUMED')
        logging.info('resuming job %d from %s (%d epochs done)',
                     job.job_number, save_dir, job.trained)
    else:
        model_cfg = model_config_from_args(args)
        opt_cfg = optimizer_config_from_args(args)
        # rank 0 draws the number (the counter file is shared)
        jn = args.job_number or broadcast_object(
            next_job_number(args.job_dir) if is_write_process() else None)
        job = new_job(model_cfg, opt_cfg, seed=args.seed, job_number=jn,
                      device=args.device)
        job.training_parameters.update({
            'set': args.dataset, 'transformer': args.transformer,
            'data_augmentation': list(args.data_augmentation),
            'epochs': args.epochs, 'batch_size': args.batch_size,
            'validation': args.validation})
        if args.freeze:
            job.training_parameters['frozen_modules'] = list(args.freeze)
        if args.pretrained_features or args.pretrained_upsampler:
            # donor checkpoints copied in and frozen (ref conv.py:237-243)
            transfer_pretrained(job, features_from=args.pretrained_features,
                                upsampler_from=args.pretrained_upsampler)
        dataset = args.dataset
        save_dir = save_dir_for(job, args.job_dir, args.latent_sampling,
                                args.data_augmentation)
        if args.where:                      # ref train.py:267-269
            print(save_dir)
            return 0

    if args.show or args.dry_run:
        print(json.dumps(job.model_cfg.architecture, indent=1))
    if args.dry_run:
        print('dry run: job {} would train {} epochs on {} -> {}'.format(
            job.job_number, args.epochs, dataset, save_dir))
        return 0
    if args.show:
        return 0

    # augmentation is applied per batch by the DataLoader
    trainset, testset = get_dataset(dataset, transformer=args.transformer,
                                    size=args.dataset_size)
    oodsets = []
    ood_names = (args.oodsets if args.oodsets is not None
                 else get_same_size_by_name(dataset))
    for n in ood_names:
        try:
            _, s = get_dataset(n, transformer=args.transformer,
                               splits=['test'], size=args.dataset_size)
            oodsets.append(s)
        except (ValueError, FileNotFoundError) as e:
            logging.debug('skipping oodset %s: %s', n, e)

    # sanity forward pass (ref train.py:307-318)
    dev = job.device
    out = evaluate(job.model, to_device(trainset[:4][0], dev),
                   to_device(trainset.targets[:4], dev),
                   sigma_state=job.sigma_state, train=False,
                   generator=make_generator(dev, 0))
    total = float(torch.mean(out.losses['total']))
    if not np.isfinite(total):
        raise SystemExit('sanity pass failed: total loss {}'.format(total))
    logging.info('sanity pass ok (total=%.4f); saving to %s', total, save_dir)

    writer = is_write_process()
    outputs = EpochOutput(stdout=writer)
    os.makedirs(save_dir, exist_ok=True)
    if writer:
        outputs.add_file(os.path.join(save_dir, 'output.out'))
    if args.output_dir and writer:         # ref train.py:271-275
        os.makedirs(args.output_dir, exist_ok=True)
        outputs.add_file(os.path.join(
            args.output_dir, 'train-{:06d}.out'.format(job.job_number)))

    try:
        train_model(job, trainset, testset, oodsets,
                    epochs=args.epochs, batch_size=args.batch_size,
                    test_batch_size=args.test_batch_size,
                    validation=args.validation,
                    data_augmentation=args.data_augmentation,
                    warmup=_ramp(args.warmup),
                    warmup_gamma=_ramp(args.warmup_gamma),
                    full_test_every=args.full_test_every,
                    ood_detection_every=args.ood_detection_every,
                    test_sample_size=args.test_sample_size,
                    save_dir=save_dir, signal_handler=default_handler(),
                    outputs=outputs, seed=args.seed,
                    fine_tuning=args.fine_tuning,
                    final_test=not args.no_final_test,
                    final_ood=not args.no_final_ood,
                    device_data=args.device_data, mesh=mesh)
    finally:
        outputs.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
