"""Pretrained sub-module transfer and freezing.

Port of ``joint_vae_tpu/save_load/transfer.py``.  Ref behaviour:
``pretrained_features`` / ``pretrained_upsampler`` load conv stacks from
another job's checkpoint and freeze them (ref cvae.py:241-247,311-317;
conv.py:237-243 sets requires_grad False).

Here: copy the donor job's ``features_stack`` / ``imager`` parameters
from its ``state.npz`` (either package's) into the job's model and list
the frozen subtrees in ``training_parameters['frozen_modules']``, which
the train step's grad mask reads (``train/state.py::grad_mask``).  The
donor's BatchNorm statistics are not copied, as in the JAX package.
"""

import logging
import os
from typing import Optional

from .checkpoint import load_arrays
from .from_jax import jax_to_state_dict, param_paths
from .jobs import Job


def _subtree_arrays(job_dir: str, prefix: str):
    arrays = load_arrays(os.path.join(job_dir, 'state.npz'))
    key = 'params/{}/'.format(prefix)
    return {k: v for k, v in arrays.items() if k.startswith(key)}


def transfer_pretrained(job: Job, features_from: Optional[str] = None,
                        upsampler_from: Optional[str] = None) -> Job:
    """Copy donor conv-stack parameters into the job's model and mark
    them frozen."""
    frozen = list(job.training_parameters.get('frozen_modules') or [])
    model = job.model
    for src, name in ((features_from, 'features_stack'),
                      (upsampler_from, 'imager')):
        if not src:
            continue
        donor = _subtree_arrays(src, name)
        if not donor:
            raise ValueError('{} has no {} params'.format(src, name))
        wanted = [p for p in param_paths(model).values()
                  if p.startswith(name + '/')]
        missing = [p[len(name) + 1:] for p in wanted
                   if 'params/' + p not in donor]
        if missing:
            raise ValueError('pretrained {} missing keys: {}'.format(
                name, missing[:5]))
        model.load_state_dict(jax_to_state_dict(model, donor, strict=False))
        frozen.append(name)
        logging.info('transferred %s from %s (frozen)', name, src)
    job.training_parameters['frozen_modules'] = frozen
    job.training_parameters['pretrained_features'] = features_from
    job.training_parameters['pretrained_upsampler'] = upsampler_from
    return job


def frozen_modules_mask_filter(job: Job):
    """Names of top-level parameter subtrees that must not receive
    gradients."""
    return set(job.training_parameters.get('frozen_modules') or [])
