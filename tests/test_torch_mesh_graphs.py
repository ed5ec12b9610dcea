"""The mesh programs as graphs (``train/graphs.py::graph_mode`` on a
mesh), on the CPU, where a graph's body runs on its static buffers: the
code that the card captures with its collectives inside.

One launch of four spawned gloo ranks (``tests/torch_mp_worker.py``,
case 'graphs') on a JAX-made job at the tiny widths of
``tests/test_torch_trainer_mesh.py``:

- 12 train steps on a (data 2, model 2) mesh, ``graphed=True`` against
  ``graphed=False``: every metric, the history and the weights bit for
  bit; with zero noise, within 1e-4 of JAX's ``train_model`` on
  ``make_mesh(4, model_axis=2)``;
- WIM ``finetune`` (its fine-tune step and both-prior batches) graphed
  against eager, bit for bit;
- mesh-fed ``ood_detection_rates`` at ``model_axis=2`` and at
  ``sample_axis=2`` graphed against eager, bit for bit, on sets whose
  batches of 6 run split over 'data' (3 rows a rank) before a tail of 3
  that runs whole on every rank;
- the per-epoch mean losses on the same batches graphed against eager
  bit for bit and against the one-process run within 1e-6;
- the split batches and the whole tail, whose inputs have the same
  shapes, never share a graph entry: each entry is keyed by its mesh
  scope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.data.loaders import ArrayDataset as JArrayDataset
from joint_vae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.train.optimizers import OptimizerConfig as JOptimizerConfig
from joint_vae_tpu.train.trainer import train_model as jax_train_model
from joint_vae_tpu.utils.print_log import EpochOutput as JEpochOutput

from joint_vae_tpu_torch.models.cvnet import CVNet
from joint_vae_tpu_torch.save_load.from_jax import jax_to_state_dict
from joint_vae_tpu_torch.save_load.jobs import load_job
from joint_vae_tpu_torch.train import trainer

import torch_mp_worker as W
from torch_port_util import jax_arrays, mesh_cfg, port_cfg

TRAIN = dict(n_train=64, epochs=3, batch_size=16)     # 3 x 4 = 12 steps


def _jax_job(d):
    job = jjobs.new_job(mesh_cfg(), JOptimizerConfig(lr=3e-3),
                        key=jax.random.PRNGKey(0))
    jjobs.save_job(job, d)
    return job


@pytest.fixture(scope='module')
def job_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('mgr') / 'job')
    _jax_job(d)
    return d


@pytest.fixture(scope='module')
def ranks(job_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp('mgr_run'))
    return W.launch('graphs', 4, out, job_dir=job_dir, **TRAIN)


def _bits(got, want, what=''):
    """Equal bit for bit: dicts key for key, arrays by bytes, floats by
    value."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _bits(got[k], want[k], '{}/{}'.format(what, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _bits(a, b, '{}[{}]'.format(what, i))
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert got.tobytes() == want.tobytes(), what
    else:
        assert got == want or (got != got and want != want), what


def test_mesh_train_step_graph_equals_eager(ranks):
    for r, res in enumerate(ranks):
        g, e = res['train_graph'], res['train_eager']
        assert g['graphed'] and g['entries'] == 1
        assert not e['graphed'] and e['entries'] == 0
        assert len(g['steps']) == 12
        _bits(g['steps'], e['steps'], 'rank {} steps'.format(r))
        _bits(g['history'], e['history'], 'rank {} history'.format(r))
        _bits(g['weights'], e['weights'], 'rank {} weights'.format(r))


def test_mesh_train_step_graph_matches_jax_mesh(ranks, tmp_path,
                                                monkeypatch):
    """Zero noise on both sides (z = mu): the graphed (2, 2) run against
    JAX's train_model on make_mesh(4, model_axis=2), within 1e-4."""
    jjob = _jax_job(str(tmp_path / 'job'))

    def jax_fake(key, mu, log_var, L, dist, sampled):
        return (jnp.broadcast_to(mu[None], (L + 1,) + mu.shape),
                jnp.zeros((L,) + mu.shape, mu.dtype))
    monkeypatch.setattr(jev, 'reparameterize', jax_fake)
    x, y = W.data(TRAIN['n_train'], 1)
    jax_train_model(jjob, JArrayDataset(x, y, 'blobs'), None, [],
                    epochs=TRAIN['epochs'], batch_size=TRAIN['batch_size'],
                    outputs=JEpochOutput(stdout=False), seed=3,
                    final_test=False, final_ood=False,
                    mesh=jax_make_mesh(4, model_axis=2))
    want = jax_to_state_dict(CVNet(port_cfg(jjob.model_cfg)),
                             jax_arrays(jjob.state))
    for r in ranks:
        got = r['train_graph_zero_noise']
        assert got['graphed']
        for e in (1, 2, 3):
            np.testing.assert_allclose(
                [got['history'][e]['train_loss'][k]
                 for k in sorted(jjob.train_history[e]['train_loss'])],
                [jjob.train_history[e]['train_loss'][k]
                 for k in sorted(jjob.train_history[e]['train_loss'])],
                rtol=1e-4, atol=1e-4)
        for n, v in got['weights'].items():
            np.testing.assert_allclose(v, want[n].numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=n)


def test_mesh_finetune_graph_equals_eager(ranks):
    for r, res in enumerate(ranks):
        _bits(res['wim_graph']['weights'], res['wim_eager']['weights'],
              'rank {} weights'.format(r))
        _bits(res['wim_graph']['ood'], res['wim_eager']['ood'],
              'rank {} ood'.format(r))


@pytest.mark.parametrize('axis', ['model2', 'sample2'])
def test_mesh_fed_ood_graph_equals_eager(ranks, axis):
    for r, res in enumerate(ranks):
        got = res['ood_{}_graph'.format(axis)]
        assert got['noise'], 'no OOD entries'
        _bits(got, res['ood_{}_eager'.format(axis)],
              'rank {} {}'.format(r, axis))


def test_mesh_mean_losses_graph_equals_eager_and_one_process(ranks,
                                                             job_dir):
    one = trainer._mean_losses(load_job(job_dir, device='cpu'),
                               W.dataset(15, 2), 6, 0)
    for r, res in enumerate(ranks):
        _bits(res['losses_graph'], res['losses_eager'],
              'rank {}'.format(r))
        for part, want in zip(res['losses_graph'], one):
            assert set(part) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(part[k], v, rtol=1e-6,
                                           atol=1e-6, err_msg=k)


@pytest.mark.parametrize('program', ['losses', 'ood_model2', 'ood_sample2'])
def test_split_and_unsplit_batches_never_share_an_entry(ranks, program):
    """A split batch's rows on a rank (3 of 6) and the whole tail (3)
    have the same input shapes; their entries differ by the scope."""
    for res in ranks:
        keys = res['{}_entries'.format(program)]
        assert len(keys) == 2, keys
        (scope_a, shapes_a), (scope_b, shapes_b) = keys
        assert shapes_a == shapes_b
        assert scope_a[0] is True and scope_b[0] is False
