"""imagenet64 (``models/cvnet.py::imagenet64_config``: vgg16 features on
3x64x64, C=1000, K=256) on the port's device mesh, as the JAX package
runs it with its 1000x256 prior split over 'model'
(``__graft_entry__.py``'s imagenet64 mesh dry run):

- the sharding rules at full width against JAX's ``state_shardings``:
  the prior's mean and variance split over 'model' (500-row blocks at
  model 2), the trunk and decoder replicated; each rank of a (1, 2) mesh
  holds its 500-row block of the prior and its Adam moments;
- spawned gloo ranks (``tests/torch_mp_worker.py``, one launch of two,
  started by the first test and run beside the in-process work): on the
  narrowed imagenet64 twin (the layer kinds of
  ``tests/test_torch_imagenet64.py``'s twin, at imagenet64's whole prior:
  C=1000, K=256) ``ood_detection_rates`` at ``model_axis=2`` (C=500 a
  rank: the combine's plain version on (500, N)) against one process
  (AUCs equal, means and stds within rtol 1e-6), and ``train_model`` at
  (data 1, model 2) and (data 2, model 1) against one process on one
  thread, as each rank runs, within 1e-5 (per-step metrics, history,
  weights; the two-rank runs' tolerance on the card, ``chip_smoke.py``'s
  MESH_STEP_RTOL): at K=256 the batch means of ``var_kl``, a sum of
  cancelling terms, round 5e-6 apart when the rows split over 'data'; at
  model 2 every gradient is bit-equal.  The metric ``grad_norm`` is held
  to the float64 norm of the one-process run's gradient, within 1e-5 or
  within twice the one-process float32 norm's own distance from it (up to
  2e-5: a float32 sum of 40 million squares); one full-width step at
  (data 1, model 2), batch 2, its losses against the JAX package's
  training-mode ``evaluate`` (the loss its train step reports) on the same
  weights (the bridge) and injected noise within 5e-4.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import joint_vae_tpu.models.evaluate as jev
from joint_vae_tpu.models.cvnet import CVNet as JCVNet
from joint_vae_tpu.ops.sigma import SigmaState as JSigmaState
from joint_vae_tpu.parallel import mesh as jmesh
from joint_vae_tpu.save_load.checkpoint import unflatten_into
from joint_vae_tpu.train.optimizers import OptimizerConfig as JOptimizerConfig
from joint_vae_tpu.train.state import create_train_state as jcreate_state

from joint_vae_tpu_torch.evals.engines import ood_detection_rates
from joint_vae_tpu_torch.models.cvnet import CVNet, imagenet64_config
from joint_vae_tpu_torch.parallel import mesh as tmesh
from joint_vae_tpu_torch.save_load.from_jax import state_dict_to_jax
from joint_vae_tpu_torch.save_load.jobs import load_job, new_job, save_job
from joint_vae_tpu_torch.train import trainer
from joint_vae_tpu_torch.train.optimizers import OptimizerConfig
from joint_vae_tpu_torch.train.state import make_generator
from joint_vae_tpu_torch.utils.print_log import EpochOutput

import torch_mp_worker as W
from torch_port_util import inject_jax_eps, make_eps, port_cfg

SHAPE = (3, 16, 16)
C = 1000
# a batch and a ragged tail a set; 2 epochs of one step: a C=1000 batch
# measures the prior's 1000 x 1000 distances (models/layers.py: capacity,
# dict_min_distance), ~3 s on one thread
OOD = {'n_test': 12, 'n_ood': 10, 'batch_size': 8, 'model_axis': 2}
TRAIN = {'n_train': 8, 'epochs': 2, 'batch_size': 8}
TRAIN_RTOL = 1e-5
SPLIT = ['classifier.head.bias', 'classifier.head.weight', 'prior.mean',
         'prior.var_param']
TRAIN_MESHES = {'model2': {'model_axis': 2}, 'data2': {'model_axis': 1}}
FULL_SEED, FULL_N = 3, 2


def _twin_cfg():
    """imagenet64's layer kinds at a few layers and narrow widths, with
    its whole prior (C=1000, K=256, the learned means' init 17)."""
    return dataclasses.replace(
        graft._imagenet64_cfg(), input_shape=SHAPE,
        features='[x3-Mx2]8-8-M-16-M-16-M-Ax1',
        upsampler='[x4:2+1]16x4:1+0-8-8-!3x5:1+2',
        encoder=(32,), decoder=(32,), test_latent_sampling=4, gamma=100.0)


def _full_inputs():
    cfg = imagenet64_config()
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (FULL_N,) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_labels, FULL_N).astype(np.int64)
    eps = make_eps((cfg.latent_sampling + 1, FULL_N, cfg.latent_dim),
                   seed=9)
    return {'x': x, 'y': y, 'eps': eps}


@pytest.fixture(scope='module')
def twin_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('im64mesh') / 'job')
    save_job(new_job(port_cfg(_twin_cfg()), OptimizerConfig(lr=1e-3),
                     seed=0, device='cpu'), d)
    return d


@pytest.fixture(scope='module')
def ranks(twin_dir, tmp_path_factory):
    """The two ranks' results, launched in a thread: a test reads them
    with ``.result()`` after its own work."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(
        W.launch, 'im64', 2, str(tmp_path_factory.mktemp('im64ranks')),
        timeout=300.0, job_dir=twin_dir, shape=SHAPE, classes=C,
        ood={'model2': OOD}, train=TRAIN_MESHES, train_args=TRAIN,
        full=_full_inputs(), full_seed=FULL_SEED)
    yield fut
    pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# in process: the sharding rules at full width
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_shapes():
    """The JAX package's imagenet64 train state, as shapes."""
    return jax.eval_shape(lambda k: jcreate_state(
        JCVNet(graft._imagenet64_cfg()), k, JOptimizerConfig()),
        jax.random.PRNGKey(0))


@pytest.mark.parametrize('model_axis', [2, 4])
def test_imagenet64_sharding_rules_match_jax(jax_shapes, model_axis, ranks):
    """Every parameter's spec on an (8 / m, m) mesh equals JAX's
    ``state_shardings``; the split ones are the prior's mean and variance
    and the class head, on their class axis, as the JAX dry run asserts
    for the mean.  (Requesting ``ranks`` starts the spawned ranks.)"""
    jm = jmesh.make_mesh(8, model_axis=model_axis)
    shard = jmesh.state_shardings(jm, jax_shapes)
    assert tuple(shard.params['prior']['mean'].spec)[0] == 'model'
    want = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(shard.params):
        names = [getattr(k, 'key', str(k)) for k in path]
        want['/'.join(names)] = tuple(s for s in sh.spec)
    model = CVNet(imagenet64_config())
    layout = tmesh._jax_layout(model)
    got = tmesh.state_shardings(
        tmesh.Mesh({'data': 8 // model_axis, 'model': model_axis}), model)
    assert {p for p, _, _ in layout.values()} == set(want)

    def strip(spec):
        spec = tuple(spec)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        return spec
    split = set()
    for name, sh in got.items():
        path, _, transposed = layout[name]
        spec = strip(sh.spec)
        if transposed and spec:
            spec = strip(reversed(spec + (None,) * (2 - len(spec))))
        assert spec == strip(want[path]), (name, spec, want[path])
        if spec:
            split.add(name)
    assert split == set(SPLIT)


def test_imagenet64_ranks_hold_500_row_prior_blocks():
    """On a (1, 2) mesh each rank keeps its 500-row block of the prior's
    mean and variance and of the class head, and of their Adam moments;
    every trunk and decoder tensor stays whole; the two blocks rebuild
    the whole."""
    cfg = imagenet64_config()
    whole = new_job(cfg, seed=1, device='cpu')
    full = {n: p.detach().clone() for n, p in whole.model.named_parameters()}
    blocks = {}
    for r in range(2):
        st = new_job(cfg, seed=1, device='cpu').state
        mesh = tmesh.Mesh({'data': 1, 'model': 2}, rank=r,
                          device=torch.device('cpu'))
        tmesh.ensure_placed(st, mesh)
        assert tmesh.split_names(st.model) == set(SPLIT)
        for n, p in st.model.named_parameters():
            if n in SPLIT:
                assert p.shape[0] == C // 2 and p.shape[1:] == \
                    full[n].shape[1:], n
                assert st.opt_state.mu[n].shape == p.shape
                blocks.setdefault(n, {})[r] = p.detach()
            else:
                assert p.shape == full[n].shape, n
        assert tuple(st.model.get_parameter('prior.mean').shape) == (500, 256)
    for n, b in blocks.items():
        assert torch.equal(torch.cat([b[0], b[1]]), full[n]), n


# ---------------------------------------------------------------------------
# the spawned ranks against one process and against the JAX package
# ---------------------------------------------------------------------------

def test_twin_has_imagenet64s_prior():
    cfg, full = port_cfg(_twin_cfg()), imagenet64_config()
    assert (cfg.num_labels, cfg.latent_dim, cfg.prior) == \
        (full.num_labels, full.latent_dim, full.prior)
    assert cfg.features != full.features


def test_imagenet64_ood_at_model2_matches_one_process(twin_dir, ranks):
    job = load_job(twin_dir, device='cpu')
    sets = dict(shape=SHAPE, classes=C)
    ref = ood_detection_rates(
        job, W.dataset(OOD['n_test'], 2, **sets),
        [W.dataset(OOD['n_ood'], 9, name='noise', **sets)],
        batch_size=OOD['batch_size'], recording=False,
        from_where=('compute',), generator=make_generator('cpu', 5))
    got = ranks.result()
    assert len(got) == 2
    for r in got:
        res = r['ood']['model2']['results']
        assert set(res['noise']) == set(ref['noise'])
        for m, e in ref['noise'].items():
            g = res['noise'][m]
            assert g['auc'] == e['auc'], m
            np.testing.assert_allclose(g['mean'], e['mean'], rtol=1e-6,
                                       err_msg=m)
            np.testing.assert_allclose(g['std'], e['std'], rtol=1e-6,
                                       err_msg=m)


class _Norm64:
    """An optimizer that records the float64 norm of each gradient it is
    handed, then updates as the step's own."""

    def __init__(self, tx, into: list):
        self.tx, self.into = tx, into

    def update(self, grads, *a, **k):
        self.into.append(float(torch.sqrt(sum(
            torch.sum(g.double() ** 2) for g in grads.values()))))
        return self.tx.update(grads, *a, **k)


@pytest.fixture(scope='module')
def one_process_train(twin_dir):
    """The port's own run on the twin, on one thread as each rank runs:
    per-step metrics, the float64 norm of each step's gradient, history,
    weights."""
    job = load_job(twin_dir, device='cpu')
    steps, norms = [], []
    make = trainer.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)
        step.tx = _Norm64(step.tx, norms)

        def run(state, x, y, eps=None):
            state, m = step(state, x, y, eps)
            steps.append({k_: float(v) for k_, v in m.items()})
            return state, m
        return run
    trainer.make_train_step = recording
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer.train_model(job, W.dataset(TRAIN['n_train'], 1, shape=SHAPE,
                                           classes=C), None,
                            epochs=TRAIN['epochs'],
                            batch_size=TRAIN['batch_size'],
                            outputs=EpochOutput(stdout=False), seed=3,
                            final_test=False, final_ood=False)
    finally:
        trainer.make_train_step = make
        torch.set_num_threads(threads)
    w = {n: p.detach().numpy() for n, p in job.model.named_parameters()}
    hist = {e: job.train_history[e] for e in job.train_history
            if isinstance(e, int)}
    assert len(norms) == len(steps)
    return steps, norms, hist, w


def _close_tree(got, want, tol, what=''):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_tree(got[k], want[k], tol, '{}/{}'.format(what, k))
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=tol,
                                   atol=tol, err_msg=what)


@pytest.mark.parametrize('mesh', sorted(TRAIN_MESHES))
def test_imagenet64_trajectory_on_mesh_matches_one_process(
        one_process_train, ranks, mesh):
    steps, norms, hist, w = one_process_train
    n = TRAIN['epochs'] * TRAIN['n_train'] // TRAIN['batch_size']
    assert len(steps) == n
    for r, res in enumerate(ranks.result()):
        run = res['train_' + mesh]
        assert run['split'] == (SPLIT if mesh == 'model2' else [])
        got = [m for m, _ in run['steps']]
        assert len(got) == n
        for i, (a, b) in enumerate(zip(got, steps)):
            what = 'rank {} step {}'.format(r, i)
            own = abs(b['grad_norm'] - norms[i])
            assert abs(a.pop('grad_norm') - norms[i]) <= max(
                TRAIN_RTOL * norms[i], 2 * own), what
            _close_tree(a, {k: v for k, v in b.items() if k != 'grad_norm'},
                        TRAIN_RTOL, what)
        _close_tree(run['history'], hist, TRAIN_RTOL, 'history')
        _close_tree(run['weights'], w, TRAIN_RTOL, 'weights')


def test_imagenet64_full_width_step_on_mesh_matches_jax(ranks, monkeypatch):
    """The full-width model's step at (data 1, model 2), batch 2: each
    rank's losses against JAX's training-mode evaluate on the same
    weights, carried over by the bridge, and the same injected noise."""
    jcfg = graft._imagenet64_cfg()
    inp = _full_inputs()
    job = new_job(port_cfg(jcfg), seed=FULL_SEED, device='cpu')
    module = JCVNet(jcfg)
    template = jax.eval_shape(lambda: module.init(
        {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1)},
        jnp.zeros((FULL_N,) + jcfg.input_shape), None, train=False))
    variables, missing, extra = unflatten_into(
        dict(template), state_dict_to_jax(job.model))
    assert not missing and not extra
    inject_jax_eps(monkeypatch, inp['eps'])
    sig = job.state.sigma_state
    out = jev.evaluate(module, variables, jnp.asarray(inp['x']),
                       jnp.asarray(inp['y'].astype(np.int32)),
                       rng=jax.random.PRNGKey(1),
                       sigma_state=JSigmaState(
                           data=jnp.asarray(sig.data.numpy()),
                           rmse=jnp.asarray(sig.rmse.numpy())),
                       train=True, with_beta=True)
    want = {k: float(jnp.mean(v)) for k, v in out.losses.items()}
    for res in ranks.result():
        got = res['full_step']
        assert got['prior_mean_block'] == (C // 2, 256)
        assert set(want) <= set(got['metrics'])
        for k, v in want.items():
            np.testing.assert_allclose(got['metrics'][k], v, rtol=5e-4,
                                       atol=5e-4, err_msg=k)
