"""The port's device mesh (``joint_vae_tpu_torch/parallel``) against the
JAX package's and against its own one-process run.

- in process: the rank grid against JAX's ``make_mesh`` on conftest's 8
  virtual CPU devices, the sharding rules against JAX's
  ``state_shardings``, placement by blocks, the sample split, the
  data-feeding helpers against JAX's, ``distributed_init`` without a
  launcher, and the refusals;
- spawned gloo ranks (``tests/torch_mp_worker.py``, each launch with its
  own time limit): ``ood_detection_rates`` on the 'model', 'sample' and
  'data' axes against one process (AUCs equal, means within rtol 1e-6),
  the uneven tail batch and the one-time warning.

Tiny widths: INPUT_SHAPE (1, 6, 6), C=4, as tests/test_parallel.py.
"""

import numpy as np
import pytest
import torch

import jax

from joint_vae_tpu.ops.priors import PriorConfig as JPriorConfig
from joint_vae_tpu.parallel import mesh as jmesh
from joint_vae_tpu.parallel import sharded_data as jsd
from joint_vae_tpu.data.loaders import ArrayDataset as JArrayDataset
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.train.optimizers import OptimizerConfig as JOptimizerConfig

from joint_vae_tpu_torch.evals.engines import ood_detection_rates
from joint_vae_tpu_torch.parallel import mesh as tmesh
from joint_vae_tpu_torch.parallel import sharded_data as tsd
from joint_vae_tpu_torch.save_load.jobs import load_job
from joint_vae_tpu_torch.train.state import make_generator

import torch_mp_worker as W
from torch_port_util import mesh_cfg as jax_cfg
from torch_port_util import port_cfg

C = 4


@pytest.fixture(scope='module')
def job_dir(tmp_path_factory):
    """A JAX-made job (test L=3) saved for the ranks to load."""
    d = str(tmp_path_factory.mktemp('par') / 'job')
    job = jjobs.new_job(jax_cfg(), JOptimizerConfig(lr=3e-3),
                        key=jax.random.PRNGKey(0))
    jjobs.save_job(job, d)
    return d


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n,model_axis,sample_axis',
                         [(8, 1, 1), (8, 2, 1), (8, 4, 1), (8, 2, 2),
                          (4, 2, 1), (4, 1, 2)])
def test_rank_grid_matches_jax_device_order(n, model_axis, sample_axis):
    """Rank r sits where JAX's make_mesh puts device r."""
    jm = jmesh.make_mesh(n, model_axis=model_axis, sample_axis=sample_axis)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    grid = tmesh.mesh_coords(n, model_axis, sample_axis)
    np.testing.assert_array_equal(grid, ids)
    shape = dict(jm.shape)
    for r in range(n):
        m = tmesh.Mesh(shape, rank=r)
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert tuple(m.coords[a] for a in jm.axis_names) == where
        assert m.axis_names == tuple(jm.axis_names)


RULE_CFGS = {
    'cvae': {},
    'cvae_diag': dict(prior=JPriorConfig(dim=8, num_priors=C, init_mean=1.0,
                                         learned_means=True,
                                         var_dim='diag')),
    'vae_diag': dict(type='vae', gamma=0.0, classifier=(),
                     prior=JPriorConfig(dim=8, var_dim='diag')),
    'jvae': dict(type='jvae', y_is_coded=True,
                 prior=JPriorConfig(dim=8)),
    'cvae_c6': dict(num_labels=6, prior=JPriorConfig(
        dim=8, num_priors=6, init_mean=1.0, learned_means=True)),
}


@pytest.mark.parametrize('model_axis', [2, 4])
@pytest.mark.parametrize('name', sorted(RULE_CFGS))
def test_sharding_rules_match_jax(name, model_axis):
    """Every parameter's spec equals JAX's state_shardings on the same
    mesh shape (a Dense weight's spec is its JAX kernel's reversed)."""
    jcfg = jax_cfg(**RULE_CFGS[name])
    job = jjobs.new_job(jcfg, JOptimizerConfig(), key=jax.random.PRNGKey(0))
    jm = jmesh.make_mesh(8, model_axis=model_axis)
    shard = jmesh.state_shardings(jm, job.state)
    want = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(shard.params):
        names = [getattr(k, 'key', str(k)) for k in path]
        want['/'.join(names)] = tuple(sh.spec)
    from joint_vae_tpu_torch.models.cvnet import CVNet
    from joint_vae_tpu_torch.save_load.from_jax import param_paths
    model = CVNet(port_cfg(jcfg))
    mesh = tmesh.Mesh({'data': 8 // model_axis, 'model': model_axis})
    got = tmesh.state_shardings(mesh, model)
    paths = param_paths(model)
    layout = tmesh._jax_layout(model)
    assert set(paths.values()) == set(want)

    def strip(spec):
        spec = tuple(spec)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        return spec
    for name_, sh in got.items():
        path, shape, transposed = layout[name_]
        jspec = strip(want[path])
        # the rule on the JAX path and shape is JAX's rule
        assert strip(tmesh._prior_spec(path.split('/'), shape,
                                       model_axis)) == jspec, name_
        # and the port's layout holds it on the transposed axes
        spec = strip(sh.spec)
        if transposed and spec:
            spec = strip(reversed(spec + (None,) * (2 - len(spec))))
        assert spec == jspec, (name_, spec, jspec)


def test_put_tree_blocks_rebuild_the_state():
    """Each rank of a (2, 2) mesh keeps its model column's block of the
    class-split parameters and moments; the blocks rebuild the whole."""
    from joint_vae_tpu_torch.models.cvnet import CVNet, init_weights
    from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
    from joint_vae_tpu_torch.train.state import create_train_state
    cfg = port_cfg(jax_cfg())
    full = init_weights(CVNet(cfg), 0)
    blocks = {}
    for r in range(4):
        st = create_train_state(init_weights(CVNet(cfg), 0),
                                OptimizerConfig())
        for v in st.opt_state.mu.values():
            v.fill_(float(r))
        mesh = tmesh.Mesh({'data': 2, 'model': 2}, rank=r,
                          device=torch.device('cpu'))
        tmesh.ensure_placed(st, mesh)
        assert tmesh.ensure_placed(st, mesh) is st
        names = tmesh.split_names(st.model)
        assert names == {'prior.mean', 'prior.var_param',
                         'classifier.head.weight', 'classifier.head.bias'}
        for n in names:
            p = st.model.get_parameter(n)
            assert p.shape[0] == full.get_parameter(n).shape[0] // 2
            assert st.opt_state.mu[n].shape == p.shape
            blocks.setdefault(n, {})[mesh.index('model')] = p.detach()
    for n, b in blocks.items():
        torch.testing.assert_close(torch.cat([b[0], b[1]]),
                                   full.get_parameter(n).detach(),
                                   rtol=0, atol=0)


@pytest.mark.parametrize('same_noise', [False, True])
def test_noise_is_this_ranks_rows_of_the_global_draw(same_noise):
    """In a mesh scope a rank draws the global batch's noise from the
    generator and keeps its rows (split_sampling_per_shard), or with
    ``same_noise`` the local shape, the same on every rank; dropout
    follows the same rule."""
    from joint_vae_tpu_torch.models.layers import dropout
    from joint_vae_tpu_torch.ops.sampling import draw_epsilon
    whole = draw_epsilon((8, 3), 2, generator=make_generator('cpu', 4))
    drop = dropout(torch.ones(8, 5), 0.5, make_generator('cpu', 4))
    for r in range(2):
        mesh = tmesh.Mesh({'data': 2, 'model': 1}, rank=r)
        with tmesh.mesh_scope(mesh, same_noise=same_noise):
            got = draw_epsilon((4, 3), 2, generator=make_generator('cpu', 4))
            d = dropout(torch.ones(4, 5), 0.5, make_generator('cpu', 4))
        rows = slice(0, 4) if same_noise else slice(4 * r, 4 * r + 4)
        if same_noise:
            want = draw_epsilon((4, 3), 2, generator=make_generator('cpu', 4))
            dwant = dropout(torch.ones(4, 5), 0.5, make_generator('cpu', 4))
        else:
            want, dwant = whole[:, rows], drop[rows]
        assert torch.equal(got, want) and torch.equal(d, dwant)


def test_sample_blocks_split_unevenly():
    assert tmesh.sample_blocks(17, 2) == [(0, 9), (9, 17)]
    assert tmesh.sample_blocks(4, 3) == [(0, 2), (2, 3), (3, 4)]
    assert tmesh.sample_blocks(16, 4) == [(0, 4), (4, 8), (8, 12), (12, 16)]


@pytest.mark.parametrize('n,count', [(100, 3), (64, 4), (7, 2)])
def test_process_shard_matches_jax(n, count):
    x, y = W.data(n, 0)
    for i in range(count):
        a = jsd.process_shard(JArrayDataset(x, y, 's'), i, count)
        b = tsd.process_shard(W.dataset(n, 0, name='s'), i, count)
        np.testing.assert_array_equal(np.asarray(b.data), np.asarray(a.data))
        assert len(b) == n // count


def test_aligned_global_batch_rows_and_refusal():
    x, y = W.data(12, 0)
    for r in range(2):
        mesh = tmesh.Mesh({'data': 2, 'model': 1}, rank=r,
                          device=torch.device('cpu'))
        xs, ys = tsd.aligned_global_batch(mesh, x, y)
        np.testing.assert_array_equal(xs.numpy(), x[6 * r:6 * r + 6])
        np.testing.assert_array_equal(ys.numpy(), y[6 * r:6 * r + 6])
        # each 'data' index runs its own shard at global batch / 2
        got = list(tsd.sharded_loader(mesh, W.dataset(24, 0), 8,
                                      shuffle=False))
        xa, _ = W.data(24, 0)
        assert [b[0].shape[0] for b in got] == [4, 4, 4]
        np.testing.assert_array_equal(torch.cat([b[0] for b in got]).numpy(),
                                      xa[12 * r:12 * r + 12])
    with pytest.raises(ValueError, match='does not divide over 2'):
        tsd.aligned_global_batch(mesh, x[:5], y[:5])


def test_distributed_init_without_launcher_is_a_noop(monkeypatch):
    for k in ('WORLD_SIZE', 'RANK', 'SLURM_NTASKS'):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.distributed_init() == (1, 0)
    assert not torch.distributed.is_initialized()
    m = tmesh.make_mesh(device='cpu')
    assert m.shape == {'data': 1, 'model': 1} and m.groups == {}
    with pytest.raises(ValueError, match='needs a world of 2'):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match='do not divide'):
        tmesh.make_mesh(1, model_axis=2)


# ---------------------------------------------------------------------------
# spawned ranks: OOD evaluation on each axis against one process
# ---------------------------------------------------------------------------

def _one_process(job_dir, n_test, n_ood, batch_size):
    job = load_job(job_dir, device='cpu')
    return ood_detection_rates(job, W.dataset(n_test, 2),
                               [W.dataset(n_ood, 9, name='noise')],
                               batch_size=batch_size, recording=False,
                               from_where=('compute',),
                               generator=make_generator('cpu', 5))


def _same_results(ref, got, rows_split=False, pairs=1):
    """AUCs equal and means and stds within rtol 1e-6.  Where the rows
    split over 'data', a per-row product on half the rows may round its
    last bit otherwise on the CPU, and a two-sided ('-2s') ROC may then
    move by one (in, out) pair (as tests/test_torch_engines.py holds the
    '-2s' entries)."""
    from joint_vae_tpu_torch.ops.roc import two_sided_from_method
    assert set(got['noise']) == set(ref['noise'])
    for m, e in ref['noise'].items():
        g = got['noise'][m]
        if rows_split and two_sided_from_method(m):
            assert abs(g['auc'] - e['auc']) <= 1.0 / pairs + 1e-7, m
        else:
            assert g['auc'] == e['auc'], m
        np.testing.assert_allclose(g['mean'], e['mean'], rtol=1e-6,
                                   err_msg=m)
        np.testing.assert_allclose(g['std'], e['std'], rtol=1e-6,
                                   err_msg=m)


OOD_RUNS = {
    2: {'model2': dict(model_axis=2), 'sample2': dict(sample_axis=2),
        # data 2, 43 and 21 images: batches of 8 leave a tail of 3 and 5,
        # batches of 7 never divide the axis
        'tail': dict(n_test=43, n_ood=21, batch_size=8),
        'every-batch': dict(n_test=43, n_ood=21, batch_size=7)},
    4: {'data2-model2': dict(model_axis=2),
        'data2-sample2': dict(sample_axis=2)}}


@pytest.fixture(scope='module')
def ood_runs(job_dir, tmp_path_factory):
    """One launch per world size, its ranks running every OOD_RUNS entry
    of that world on a mesh of their own (40 and 24 images in batches of
    8 unless the entry says otherwise)."""
    out = {}
    for world, runs in OOD_RUNS.items():
        runs = {k: {'n_test': 40, 'n_ood': 24, 'batch_size': 8, **v}
                for k, v in runs.items()}
        got = W.launch('ood', world, str(tmp_path_factory.mktemp('ood')),
                       job_dir=job_dir, runs=runs)
        out.update({k: [r[k] for r in got] for k in runs})
    return out


@pytest.mark.parametrize('world,name', [
    (2, 'model2'), (2, 'sample2'), (4, 'data2-model2'),
    (4, 'data2-sample2')], ids=['model2', 'sample2', 'data2-model2',
                                'data2-sample2'])
def test_ood_on_mesh_matches_one_process(job_dir, ood_runs, world, name):
    """The mesh changes where tensors live, not the numbers: the combine
    on a class block, the decode on a block of the L+1 = 4 samples (2 + 2;
    with data 2 the rows split too), every rank's results equal one
    process's."""
    ref = _one_process(job_dir, 40, 24, 8)
    assert len(ood_runs[name]) == world
    for r in ood_runs[name]:
        _same_results(ref, r['results'], rows_split=world > 2,
                      pairs=40 * 24)
        assert not any('does not divide' in m for m in r['log'])


@pytest.mark.parametrize('name,warns', [('tail', False),
                                        ('every-batch', True)],
                         ids=['tail', 'every-batch'])
def test_uneven_batches_stay_exact_and_warn_once(job_dir, ood_runs, name,
                                                 warns):
    """A tail that does not divide the 'data' axis goes in whole and stays
    exact, with no warning; a batch size that never divides warns once
    per evaluation."""
    ref = _one_process(job_dir, 43, 21, OOD_RUNS[2][name]['batch_size'])
    assert len(ood_runs[name]) == 2
    for r in ood_runs[name]:
        _same_results(ref, r['results'], rows_split=not warns,
                      pairs=43 * 21)
        n = sum('does not divide the mesh data axis' in m for m in r['log'])
        # once per scored set (the test set and one OOD set), as the JAX
        # engine's warn state lives per set
        assert n == (2 if warns else 0)
