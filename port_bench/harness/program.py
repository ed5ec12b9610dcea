"""The system under test, ``joint_vae_tpu_torch``, as the benchmark drives
it: a job built from a configuration file with the benchmark's weights,
the trainer's entry and the scorer.  The only module of the benchmark
that imports the program; the reference never does.
"""

import time

import torch

from joint_vae_tpu_torch.data import native
from joint_vae_tpu_torch.data.loaders import ArrayDataset
from joint_vae_tpu_torch.device import set_float32_math
from joint_vae_tpu_torch.models.conv import ConvLayer
from joint_vae_tpu_torch.models.cvnet import CVNet, CVNetConfig
from joint_vae_tpu_torch.ops import cuda_lib
from joint_vae_tpu_torch.ops.priors import build_prior_config
from joint_vae_tpu_torch.ops.sigma import SigmaConfig
from joint_vae_tpu_torch.save_load.jobs import (Job,
                                                default_training_parameters)
from joint_vae_tpu_torch.serve import Scorer
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
from joint_vae_tpu_torch.train.state import create_train_state
from joint_vae_tpu_torch.train.trainer import train_model

__all__ = ['ArrayDataset', 'Scorer', 'train_model', 'model_config',
           'optimizer_config', 'build_job', 'canonical_params',
           'build_kernels']


def model_config(cfg: dict) -> CVNetConfig:
    """The program's model configuration from a benchmark configuration
    file, as its training CLI builds it from the same settings."""
    p = cfg['prior']
    prior = build_prior_config(cfg['latent_dim'], p['distribution'],
                               num_priors=p['num_priors'],
                               init_mean=p['init_mean'],
                               learned_means=p['learned_means'],
                               freeze_means=0, var_dim=p['var_dim'])
    s = cfg['sigma']
    sigma = (SigmaConfig(value=s['value'], learned=True, sdim=1)
             if s['learned'] else SigmaConfig(value=s['value'], sdim=1))
    return CVNetConfig(
        input_shape=tuple(cfg['input_shape']), num_labels=cfg['num_labels'],
        type=cfg['type'], output_distribution='gaussian',
        features=cfg['features'], upsampler=cfg['upsampler'],
        batch_norm=cfg['batch_norm'], dropout=cfg['dropout'],
        encoder=tuple(cfg['encoder']), decoder=tuple(cfg['decoder']),
        classifier=tuple(cfg['classifier']), latent_dim=cfg['latent_dim'],
        latent_sampling=cfg['latent_sampling'],
        test_latent_sampling=cfg['test_latent_sampling'],
        activation=cfg['activation'],
        output_activation=cfg['output_activation'],
        beta=cfg['beta'], gamma=cfg['gamma'], prior=prior, sigma=sigma,
        compute_dtype=cfg['compute_dtype'], iws_mode=cfg['iws_mode'])


def optimizer_config(cfg: dict) -> OptimizerConfig:
    o = cfg['optimizer']
    return OptimizerConfig(optim_type=o['type'], lr=o['lr'],
                           lr_decay=o['lr_decay'],
                           weight_decay=o['weight_decay'],
                           grad_clipping=o['grad_clipping'],
                           betas=tuple(o['betas']))


def build_job(cfg: dict, weights: dict, device, noise_seed: int) -> Job:
    """A fresh job of the configuration on ``device`` holding ``weights``
    (canonical layouts: ``harness/inputs.py``), its generator seeded with
    ``noise_seed``."""
    set_float32_math()
    mcfg, ocfg = model_config(cfg), optimizer_config(cfg)
    model = CVNet(mcfg).to(device)
    mods = dict(model.named_modules())
    with torch.no_grad():
        for name, p in model.named_parameters():
            w = weights[name]
            owner = mods.get(name.rsplit('.', 1)[0])
            if isinstance(owner, ConvLayer) and name.endswith('.weight'):
                w = owner.from_hwio(w)
            p.copy_(w)
    model.eval()
    job = Job(model_cfg=mcfg, opt_cfg=ocfg,
              state=create_train_state(model, ocfg, noise_seed))
    job.training_parameters = default_training_parameters(mcfg, ocfg)
    job.testing = {0: {m: {'n': 0, 'epochs': 0, 'accuracy': 0}
                       for m in mcfg.predict_methods}}
    return job


def canonical_params(job: Job, params: dict = None) -> dict:
    """The job's parameters (or ``params``, tensors by the same names) in
    the canonical layouts, on the host."""
    model = job.model
    mods = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        owner = mods.get(name.rsplit('.', 1)[0])
        w = (p if params is None else params[name]).detach()
        if isinstance(owner, ConvLayer) and name.endswith('.weight'):
            w = owner.to_hwio(w)
        out[name] = w.float().cpu().clone()
    return out


def build_kernels() -> float:
    """Build the program's CUDA kernels and its native batcher where the
    checkout has not built them yet (its first run), load nothing else;
    the wall seconds spent."""
    t = time.perf_counter()
    cuda_lib.build()
    native.get_lib()
    return time.perf_counter() - t
