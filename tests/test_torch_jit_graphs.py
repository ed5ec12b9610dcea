"""The JAX package's last jitted programs as scoring and step graphs
(``train/graphs.py``) on the CPU, where a graph's body runs eagerly on
its static buffers: the code that the card captures.  On the tiny
flagship cvae whose weights come from one JAX job directory:

- the trainer's per-epoch losses (``train/trainer.py::_mean_losses``),
  ``cli.aggregate``'s scores, Poscod's means, head step and scores, the
  sampling driver's correct / incorrect scan and ``record_latents``
  against the JAX package's functions with the same noise (the
  shape-seeded array of ``tests/test_torch_engines.py``), within
  docs/PARITY.md's tolerances: evaluate 5e-4, the pools and predictions
  equal, the Poscod head's Adam trajectory over 12 steps 1e-4;
- each program graphed bit for bit against its ``graphed=False`` self
  with the port's own noise: outputs, record files and the generator's
  state after them;
- the per-epoch losses across two epochs with steps between equal to a
  fresh eager call at each epoch, from one graph held on the job;
- a ragged tail's own entry, new entries for a new generator or owner,
  the runs counted by graph name and by how, and a call on a mesh over
  gloo on a card asked for a graph refused.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from joint_vae_tpu.cli import aggregate as jagg_cli
from joint_vae_tpu.data import loaders as jloaders
from joint_vae_tpu.evals import sample as jsample
from joint_vae_tpu.ft import job as jft
from joint_vae_tpu.ft import poscod as jposcod
from joint_vae_tpu.ft import wim as jwim
from joint_vae_tpu.save_load import jobs as jjobs
from joint_vae_tpu.train import trainer as jtrainer

from joint_vae_tpu_torch.cli import aggregate as tagg_cli
from joint_vae_tpu_torch.data import loaders as tloaders
from joint_vae_tpu_torch.evals import sample as tsample
from joint_vae_tpu_torch.ft import job as tft
from joint_vae_tpu_torch.ft import poscod as tposcod
from joint_vae_tpu_torch.ft import wim as twim
from joint_vae_tpu_torch.parallel.mesh import Mesh
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.train import trainer as ttrainer
from joint_vae_tpu_torch.train.graphs import (StepGraph, batches_run,
                                              held_graph, held_score_graphs,
                                              reset_steps_run, steps_run)
from joint_vae_tpu_torch.train.state import make_generator
from joint_vae_tpu_torch.utils.print_log import EpochOutput

from test_torch_engines import numpy_batches, shared_noise  # noqa: F401
from test_torch_score_graphs import _same
from torch_port_util import close

TOL = 5e-4
HEAD_TOL = 1e-4
BATCH = 16
N_SET = 40                       # 2 full batches and a ragged 8
PROGRAMS = ('mean_losses', 'aggregate', 'poscod', 'sample', 'latents')


def _jobs(tmp_path, name='job'):
    """A tiny flagship JAX job saved once, and the port's load of it."""
    jjob = jjobs.new_job(graft._flagship_cfg(tiny=True),
                         key=jax.random.PRNGKey(0))
    jjob.train_history = {'epochs': 1}
    d = str(tmp_path / name)
    jjobs.save_job(jjob, d)
    return jjob, tjobs.load_job(d, device='cpu'), d


def _sets(n=N_SET, seed=1, name='tiny'):
    rng = np.random.default_rng(seed)
    cfg = graft._flagship_cfg(tiny=True)
    x = rng.uniform(0, 1, (n,) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_labels, n).astype(np.int64)
    return (jloaders.ArrayDataset(x, y, name),
            tloaders.ArrayDataset(x, y, name))


def _wims(jjob, tjob):
    jw = jwim.WIMJob(job=jjob)
    jw.set_alternate_prior(key=jax.random.PRNGKey(3), init_mean=8.0,
                           num_priors=1, seed=3)
    tw = twim.WIMJob(job=tjob)
    tw.set_alternate_prior(init_mean=8.0, num_priors=1, seed=3)
    tw.set_alternate_prior_arrays({k: np.asarray(v) for k, v in
                                   jw.alternate_prior_params.items()})
    return jw, tw


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---- against the JAX package ------------------------------------------------

def test_mean_losses_match_jax(tmp_path, shared_noise):
    jjob, tjob, _ = _jobs(tmp_path)
    jds, tds = _sets()
    want = jtrainer._mean_losses(jjob.model, jjob.state, jds, BATCH, 2)
    reset_steps_run()
    got = ttrainer._mean_losses(tjob, tds, BATCH, 2)
    assert batches_run == {'mean_losses': {'eager': 3, 'captured': 0,
                                           'replayed': 0}}
    for w, g in zip(want, got):
        assert set(g) == set(w) and g
        for k in w:
            close(g[k], w[k], TOL, k)
    graph = held_score_graphs(tjob)['mean_losses']
    assert graph.graphed and len(graph._entries) == 2     # the ragged tail


def test_aggregate_scores_match_jax(tmp_path, shared_noise):
    jjob, tjob, _ = _jobs(tmp_path)
    jds, tds = _sets()
    want = jagg_cli._scores(jjob, jds, BATCH, jax.random.PRNGKey(0))
    got = tagg_cli._scores(tjob, tds, BATCH, 0)
    assert [g.shape for g in got] == [np.shape(w) for w in want]
    assert got[0].shape == (tjob.model_cfg.num_labels, N_SET)
    np.testing.assert_array_equal(got[1], want[1])
    for i in (0, 2, 3):
        close(got[i], want[i], TOL, str(i))
    assert got[2].flags['C_CONTIGUOUS']
    assert len(held_score_graphs(tjob)['aggregate']._entries) == 2


def test_poscod_head_and_scores_match_jax(tmp_path):
    """12 head steps (3 epochs of 28 + 28 at 8: three full pairs and a
    ragged one) against JAX's, then the scores."""
    jjob, tjob, _ = _jobs(tmp_path)
    (jind, tind), (jmov, tmov) = _sets(28, 2), _sets(28, 3, 'mov')
    jsc, tsc = _sets(20, 4, 'scored')
    jp = jposcod.PoscodJob(job=jjob).finetune(jind, jmov, epochs=3,
                                              batch_size=8, lr=1e-2, seed=0)
    reset_steps_run()
    tp = tposcod.PoscodJob(job=tjob).finetune(tind, tmov, epochs=3,
                                              batch_size=8, lr=1e-2, seed=0)
    assert steps_run == {'eager': 12, 'captured': 0, 'replayed': 0}
    assert batches_run['poscod_batch']['eager'] == 24
    for k in ('w', 'b'):
        close(tp.head[k], jp.head[k], HEAD_TOL, k)
        assert not np.all(np.asarray(jp.head[k]) == 0)
    close(tp.llr_scores(tsc, 8), jp.llr_scores(jsc, 8), HEAD_TOL, 'llr')
    # the means' entries (full, ragged) and the scores' (full, ragged)
    assert len(held_score_graphs(tjob)['poscod']._entries) == 4


def test_select_correct_incorrect_matches_jax(tmp_path, shared_noise):
    jjob, tjob, _ = _jobs(tmp_path)
    jds, tds = _sets()
    want = jsample.select_correct_incorrect(jjob, jds, 30, batch_size=BATCH)
    reset_steps_run()
    got = tsample.select_correct_incorrect(tjob, tds, 30, batch_size=BATCH)
    assert set(got) == set(want) == {'correct', 'incorrect'}
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert np.array_equal(g, w), k
    assert batches_run == {'sample_batch': {'eager': 3, 'captured': 0,
                                            'replayed': 0}}


def test_record_latents_match_jax(tmp_path, shared_noise):
    jjob, tjob, _ = _jobs(tmp_path)
    jw, tw = _wims(jjob, tjob)
    sets = [_sets(N_SET, 5, 'tiny'), _sets(12, 6, 'other')]
    jd, td = str(tmp_path / 'jax_latents'), str(tmp_path / 'port_latents')
    os.makedirs(jd), os.makedirs(td)
    jft.record_latents(jw, [s[0] for s in sets], BATCH,
                       jax.random.PRNGKey(0), jd)
    reset_steps_run()
    tft.record_latents(tw, [s[1] for s in sets], BATCH,
                       make_generator('cpu', 0), td)
    assert batches_run['latents_batch']['eager'] == 3 + 1
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    for f in os.listdir(jd):
        want, got = _npz(os.path.join(jd, f)), _npz(os.path.join(td, f))
        assert set(got) == set(want), f
        for k in want:
            close(got[k], want[k], TOL, f + '/' + k)
    # one graph across the sets: the full batch, the two tails
    assert len(held_score_graphs(tjob)['latents']._entries) == 3


# ---- each graph against its eager self ---------------------------------------

def _run(program, tmp_path, graphed):
    """Program ``program`` on a fresh load of one job, graphed or not:
    (its outputs, the generator's state after them where a caller gives
    one)."""
    _, tjob, _ = _jobs(tmp_path, 'job_{}_{}'.format(program, int(graphed)))
    tds = _sets()[1]
    if program == 'mean_losses':
        return [ttrainer._mean_losses(tjob, tds, BATCH, e, graphed=graphed)
                for e in (0, 1, 0)], None
    if program == 'aggregate':
        return [tagg_cli._scores(tjob, tds, BATCH, s, graphed=graphed)
                for s in (0, 9)], None
    if program == 'poscod':
        pc = tposcod.PoscodJob(job=tjob, graphed=graphed)
        pc.finetune(_sets(28, 2)[1], _sets(28, 3, 'mov')[1], epochs=2,
                    batch_size=8, lr=1e-2, seed=1)
        return ({k: v.reshape(-1).clone() for k, v in pc.head.items()},
                [pc.llr_scores(tds, 8, seed=s) for s in (0, 2)]), None
    if program == 'sample':
        return [tsample.select_correct_incorrect(
            tjob, tds, 30, batch_size=BATCH, seed=s, graphed=graphed)
            for s in (3, 4)], None
    tw = twim.WIMJob(job=tjob)
    tw.set_alternate_prior(init_mean=8.0, num_priors=1, seed=3)
    d = str(tmp_path / 'latents_{}'.format(int(graphed)))
    os.makedirs(d)
    gen = make_generator('cpu', 5)
    tft.record_latents(tw, [tds, _sets(12, 6, 'other')[1]], BATCH, gen, d,
                       graphed=graphed)
    files = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), 'rb') as fh:
            files[f] = fh.read()
    return files, gen.get_state()


@pytest.mark.parametrize('program', PROGRAMS)
def test_graph_equals_its_eager_self(program, tmp_path):
    reset_steps_run()
    eager, eager_gen = _run(program, tmp_path, False)
    ran_eager = {n: dict(r) for n, r in batches_run.items()}
    reset_steps_run()
    graphed, graphed_gen = _run(program, tmp_path, True)
    _same(eager, graphed, program)
    if eager_gen is not None:
        _same(eager_gen, graphed_gen, program + ' generator')
    # the same batches either way, each eager here (the CPU)
    assert {n: dict(r) for n, r in batches_run.items()} == ran_eager
    assert all(r['captured'] == r['replayed'] == 0 for r in ran_eager.values())


def test_mean_losses_across_epochs_equal_a_fresh_eager_call(tmp_path):
    """``train_model`` over two epochs with steps between: each epoch's
    validation and test losses from the graph held on the job equal an
    eager call with a fresh generator at that epoch."""
    _, tjob, _ = _jobs(tmp_path)
    trainset, testset = _sets(72, 7)[1], _sets(N_SET, 8, 'test')[1]
    real = ttrainer._mean_losses
    seen = []

    def both(job, dataset, batch_size, epoch, mesh=None, graphed=None):
        got = real(job, dataset, batch_size, epoch, mesh=mesh,
                   graphed=graphed)
        seen.append((epoch, held_score_graphs(job)['mean_losses']))
        _same(got, real(job, dataset, batch_size, epoch, graphed=False),
              'epoch {}'.format(epoch))
        return got
    ttrainer._mean_losses = both
    try:
        ttrainer.train_model(tjob, trainset, testset, epochs=3,
                             batch_size=8, test_batch_size=BATCH,
                             validation=20, final_test=False, final_ood=False,
                             full_test_every=1,
                             outputs=EpochOutput(stdout=False))
    finally:
        ttrainer._mean_losses = real
    # the job has trained one epoch: epochs 1 and 2, validation and test
    assert [e for e, _ in seen] == [1, 1, 2, 2]
    assert all(g is seen[0][1] for _, g in seen)
    h = tjob.train_history
    assert h[2]['test_loss'] != h[3]['test_loss']
    # the validation set (20: 16 + 4) and the test set (40: 16 + 16 + 8)
    assert len(seen[0][1]._entries) == 3


# ---- buffers, owners, counts, the mesh ----------------------------------------

def test_held_graph_generator_and_owners(tmp_path):
    """A held graph keeps its entries across calls and reseeds its
    generator; a caller's generator means new entries; another sigma
    state replaces the graph; graphed=False holds nothing."""
    _, tjob, _ = _jobs(tmp_path)
    tds = _sets()[1]
    tagg_cli._scores(tjob, tds, BATCH, 0)
    g = held_score_graphs(tjob)['aggregate']
    entries = dict(g._entries)
    tagg_cli._scores(tjob, tds, BATCH, 9)
    assert held_score_graphs(tjob)['aggregate'] is g
    assert all(g._entries[k] is e for k, e in entries.items())
    mine = make_generator('cpu', 1)
    graph, gen = held_graph(tjob, 'aggregate', None, generator=mine)
    assert graph is g and gen is mine
    graph(gen, x=torch.from_numpy(tds.data[:BATCH]))
    assert len(g._entries) == 1 and all(
        g._entries.get(k) is not e for k, e in entries.items())
    sigma = tjob.state.sigma_state
    tjob.state.sigma_state = dataclasses.replace(
        sigma, data=sigma.data.clone(), rmse=sigma.rmse.clone())
    tagg_cli._scores(tjob, tds, BATCH, 0)
    assert held_score_graphs(tjob)['aggregate'] is not g
    _, other, _ = _jobs(tmp_path, 'other')
    tagg_cli._scores(other, tds, BATCH, 0, graphed=False)
    assert held_score_graphs(other) == {}


def test_step_graph_owner_named_by_its_caller():
    """A step graph whose caller names its owners: the same owners keep
    the entry's buffers, another drops them; a state without noise has
    a None generator; ``steps_run`` counts every step by how."""
    seen = []

    class State:
        generator = None

        def __init__(self):
            self.w = torch.zeros(3)

    def body(state, x):
        seen.append(x.data_ptr())
        state.w.add_(x.sum(0))
        return {'s': state.w.sum()}
    reset_steps_run()
    g = StepGraph(body, name='t')
    st, a, b = State(), object(), object()
    x = torch.ones(2, 3)
    for owner in ((a,), (a,), (b,)):
        g(st, owner=owner, x=x)
    assert seen[0] == seen[1] and len(g._entries) == 1
    assert torch.equal(st.w, torch.full((3,), 6.0))
    assert steps_run == {'eager': 3, 'captured': 0, 'replayed': 0}
    assert batches_run == {}


@pytest.mark.parametrize('program', ['mean_losses', 'poscod', 'latents',
                                     'held'])
def test_mesh_call_asked_for_a_graph_raises(program, tmp_path):
    _, tjob, _ = _jobs(tmp_path)
    tds = _sets()[1]
    # a mesh over gloo on a card, refused before it is used
    mesh = Mesh({'data': 1, 'model': 1}, groups={'data': object()},
                device=torch.device('cuda'), backend='gloo')
    with pytest.raises(ValueError, match='mesh'):
        if program == 'mean_losses':
            ttrainer._mean_losses(tjob, tds, BATCH, 0, mesh=mesh,
                                  graphed=True)
        elif program == 'poscod':
            tposcod.PoscodJob(job=tjob, graphed=True).finetune(
                tds, tds, epochs=1, batch_size=8, mesh=mesh)
        elif program == 'latents':
            tft.record_latents(twim.WIMJob(job=tjob), [tds], BATCH,
                               make_generator('cpu', 0), str(tmp_path),
                               mesh=mesh, graphed=True)
        else:
            held_graph(tjob, 'x', None, mesh=mesh, graphed=True)
