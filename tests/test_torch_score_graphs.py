"""The scoring programs as graphs (``train/graphs.py::ScoreGraph``) on the
CPU, where a graph's body runs eagerly on its static buffers: the code
that the card captures.  On a tiny flagship cvae (C=10, K=8) and a tiny
vib whose weights come from one JAX job directory:

- the Scorer, ``ood_detection_rates``' compute tier (a ragged tail, ODIN
  on the vib), ``accuracy`` and the fine-tune flow's both-prior losses
  against the JAX package's with the same noise (L+1 layout, eps_0 = 0:
  the Scorer's injected, the others' from one numpy array per shape),
  within docs/PARITY.md's tolerances (evaluate 5e-4; the ROC entries as
  ``tests/test_torch_engines.py`` holds them);
- each graphed object bit for bit against its ``graphed=False`` self:
  outputs, record files and the generator's state after them;
- ``WIMJob.evaluate_on_both_priors``' one draw of the noise bit for bit
  against the two-call evaluation that replays the generator
  (``get_state`` / ``set_state``), written here;
- ``models/evaluate.py::draw_eval_epsilon``: the draw ``evaluate`` makes;
- ``models/conv.py::DeterministicConvFn``: the gradients of ``F.conv2d``
  on the CPU, bit for bit (the determinism repair changes no CPU
  number);
- the engines' graphs held on the job across calls;
- the scoring graph's buffers, owners and run counts.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import __graft_entry__ as graft
from joint_vae_tpu import serve as jserve
from joint_vae_tpu.evals import engines as jeng
from joint_vae_tpu.ft import job as jft
from joint_vae_tpu.ft import wim as jwim
from joint_vae_tpu.save_load import jobs as jjobs

from joint_vae_tpu_torch import serve as tserve
from joint_vae_tpu_torch.evals import engines as teng
from joint_vae_tpu_torch.ft import job as tft
from joint_vae_tpu_torch.ft import wim as twim
from joint_vae_tpu_torch.models.conv import DeterministicConvFn
from joint_vae_tpu_torch.models.cvnet import CVNetConfig
from joint_vae_tpu_torch.models.evaluate import draw_eval_epsilon, evaluate
from joint_vae_tpu_torch.ops.priors import PriorConfig
from joint_vae_tpu_torch.save_load import jobs as tjobs
from joint_vae_tpu_torch.train.graphs import (ScoreGraph, batches_run,
                                              reset_steps_run, steps_run)
from joint_vae_tpu_torch.train.state import make_generator

from test_torch_engines import (COMPUTE_TOL, VIB_METHODS, _close_tree,  # noqa: F401
                                _sets, numpy_batches, shared_noise)
from torch_port_util import close, inject_jax_eps, make_eps

METHODS = ('iws', 'elbo', 'zdist', 'mse', 'soft', 'iws-2s', 'elbo-2s')
C, K, BATCH = 10, 8, 16


def _jcfg(type_='cvae'):
    cfg = graft._flagship_cfg(tiny=True)
    cfg = dataclasses.replace(cfg, num_labels=C, latent_dim=K,
                              prior=dataclasses.replace(cfg.prior, dim=K,
                                                        num_priors=C))
    if type_ == 'vib':
        cfg = dataclasses.replace(cfg, type='vib', test_latent_sampling=3)
    return cfg


def _jobs(tmp_path, type_='cvae', name='job'):
    """A JAX job saved once, and the port's load of a copy."""
    jjob = jjobs.new_job(_jcfg(type_), key=jax.random.PRNGKey(0))
    jjob.train_history = {'epochs': 1}
    d = str(tmp_path / name)
    jjobs.save_job(jjob, d)
    return jjob, tjobs.load_job(d, device='cpu'), d


def _x(n, seed=5):
    return np.random.default_rng(seed).uniform(
        0, 1, (n,) + _jcfg().input_shape).astype(np.float32)


def _same(a, b, what=''):
    """Nests of arrays, tensors and numbers equal bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), (what, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], '{}/{}'.format(what, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, '{}[{}]'.format(what, i))
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8)), what
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b or (a != a and b != b), (what, a, b)


def _record_bytes(d: str) -> dict:
    out = {}
    for root, _, files in os.walk(os.path.join(d, 'samples')):
        for f in files:
            with open(os.path.join(root, f), 'rb') as fh:
                out[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    return out


@pytest.mark.parametrize('n', [BATCH, 5], ids=['full', 'ragged'])
def test_scorer_graph_matches_jax_and_its_eager_self(n, tmp_path,
                                                     monkeypatch):
    jjob, tjob, _ = _jobs(tmp_path)
    x = _x(n)
    eps = make_eps((jjob.model_cfg.test_latent_sampling + 1, n, K))
    inject_jax_eps(monkeypatch, eps)
    free = {m: float('-inf') for m in METHODS}
    probe = jserve.Scorer(jjob, methods=METHODS, thresholds=free)(x)
    thr = {m: float(np.median(np.asarray(v)))
           for m, v in probe['scores'].items()}
    want = jserve.Scorer(jjob, methods=METHODS, thresholds=thr)(x)
    scorer = tserve.Scorer(tjob, methods=METHODS, thresholds=thr)
    assert scorer.graph.graphed
    got = scorer(x, eps=torch.from_numpy(eps))
    np.testing.assert_array_equal(got['label'], np.asarray(want['label']))
    np.testing.assert_array_equal(got['in_distribution'],
                                  np.asarray(want['in_distribution']))
    close(got['confidence'], np.asarray(want['confidence']), COMPUTE_TOL)
    for m in METHODS:
        close(got['scores'][m], np.asarray(want['scores'][m]), COMPUTE_TOL, m)
    # the graph against its eager self: injected noise, a caller's
    # generator, the default noise (the same every call)
    eager = tserve.Scorer(tjob, methods=METHODS, thresholds=thr,
                          graphed=False)
    gens = {g: make_generator('cpu', 3) for g in (False, True)}
    runs = {}
    for graphed, s in ((False, eager), (True, scorer)):
        runs[graphed] = ([s(x, eps=torch.from_numpy(eps))]
                         + [s(x, generator=gens[graphed]) for _ in range(2)]
                         + [s(x) for _ in range(2)])
    _same(runs[False], runs[True])
    _same(gens[False].get_state(), gens[True].get_state())
    _same(runs[True][3], runs[True][4])
    assert runs[True][1]['scores']['iws'].tobytes() != \
        runs[True][2]['scores']['iws'].tobytes()


@pytest.mark.parametrize('type_', ['cvae', 'vib'])
def test_ood_compute_tier_graph_matches_jax_and_its_eager_self(
        type_, tmp_path, shared_noise):
    jjob, _, dj = _jobs(tmp_path, type_, 'jax')
    jjob.saved_dir = dj
    methods = METHODS if type_ == 'cvae' else VIB_METHODS
    # 40 = 2 full batches + a ragged 8: one graph each
    (jts, tts), (jo1, to1) = _sets(40, 1, 'test', C), _sets(24, 2, 'ooda', C)
    kw = dict(batch_size=BATCH, method=list(methods), from_where=('compute',))
    want = jeng.ood_detection_rates(jjob, jts, [jo1], **kw)
    got, records = {}, {}
    for graphed in (True, False):
        d = str(tmp_path / 'port{}'.format(int(graphed)))
        jjobs.save_job(jjob, d)
        tjob = tjobs.load_job(d, device='cpu')
        reset_steps_run()
        got[graphed] = teng.ood_detection_rates(tjob, tts, [to1],
                                                graphed=graphed, **kw)
        runs = batches_run['score_batch']
        assert runs['eager'] == 3 + 2 and runs['captured'] == 0
        records[graphed] = _record_bytes(d)
    _close_tree(got[True], want, COMPUTE_TOL, 'ood', one_sample=1 / 24)
    _same(got[True], got[False])
    assert records[True] == records[False] and len(records[True]) == 2


def test_accuracy_graph_matches_jax_and_its_eager_self(tmp_path,
                                                       shared_noise):
    jjob, _, dj = _jobs(tmp_path, name='jax')
    jts, tts = _sets(40, 1, 'test', C)
    kw = dict(batch_size=BATCH, from_where=('compute',), recording=False)
    want = jeng.accuracy(jjob, jts, **kw)
    got = {}
    for graphed in (True, False):
        tjob = tjobs.load_job(dj, device='cpu')
        tjob.saved_dir = None
        reset_steps_run()
        got[graphed] = teng.accuracy(tjob, tts, graphed=graphed, **kw)
        assert batches_run['accuracy_batch']['eager'] == 3
    assert got[True] == want and set(want) == set(jjob.model_cfg
                                                  .predict_methods)
    assert got[True] == got[False]


def test_both_prior_losses_graph_match_jax_and_its_eager_self(tmp_path,
                                                              shared_noise):
    jjob, tjob, _ = _jobs(tmp_path)
    jw = jwim.WIMJob(job=jjob)
    jw.set_alternate_prior(key=jax.random.PRNGKey(3), init_mean=8.0,
                           num_priors=1, seed=3)
    tw = twim.WIMJob(job=tjob)
    tw.set_alternate_prior(init_mean=8.0, num_priors=1, seed=3)
    tw.set_alternate_prior_arrays({k: np.asarray(v) for k, v in
                                   jw.alternate_prior_params.items()})
    jds, tds = _sets(40, 6, 'test', C)
    want = jft._both_prior_losses(jw, jds, BATCH, jax.random.PRNGKey(1))
    got = {}
    for graphed in (True, False):
        reset_steps_run()
        gen = make_generator('cpu', 10)
        got[graphed] = (tft._both_prior_losses(
            tw, tds, BATCH, gen, graph=tft.both_prior_graph(
                tw, graphed=graphed)), gen.get_state())
        assert batches_run['both_prior_batch']['eager'] == 3
    assert set(got[True][0]) == set(want)
    assert any(k.endswith('@') for k in want)
    for k, v in want.items():
        close(got[True][0][k], v, COMPUTE_TOL, k)
    _same(got[True], got[False])


def test_engines_hold_their_graphs_across_calls(tmp_path):
    """The engines' graphs and generator are held on the job: a second
    call replays the same graph, reseeded (the first call's numbers, and
    a ``graphed=False`` call's); another sigma state replaces the graph;
    an eager call holds none."""
    _, tjob, d = _jobs(tmp_path)
    tts, to1 = _sets(40, 1, 'test', C)[1], _sets(24, 2, 'ooda', C)[1]
    kw = dict(batch_size=BATCH, method=list(METHODS), from_where=('compute',),
              update_self_ood=False, recording=False)
    akw = dict(batch_size=BATCH, from_where=('compute',), recording=False,
               update_self_testing=False)

    def calls(job, graphed):
        return (teng.ood_detection_rates(job, tts, [to1], graphed=graphed,
                                         **kw),
                teng.accuracy(job, tts, graphed=graphed, **akw))
    first = calls(tjob, None)
    held = teng.held_score_graphs(tjob)
    assert set(held) == {'ood', 'accuracy'}
    assert held['ood'].graphed and held['accuracy'].graphed
    _same(calls(tjob, None), first)
    assert all(teng.held_score_graphs(tjob)[k] is g for k, g in held.items())
    eager = tjobs.load_job(d, device='cpu')
    _same(calls(eager, False), first)
    assert teng.held_score_graphs(eager) == {}
    sigma = tjob.state.sigma_state
    tjob.state.sigma_state = dataclasses.replace(
        sigma, data=sigma.data.clone(), rmse=sigma.rmse.clone())
    _same(calls(tjob, None), first)
    assert all(teng.held_score_graphs(tjob)[k] is not g
               for k, g in held.items())


def _two_call_reference(wim, x, sigma_state, generator, L=None):
    """The both-prior evaluation as it was: the first evaluation draws its
    noise, the generator is set back, the second draws it again, then the
    generator is set where the first left it."""
    replay = generator.get_state()
    out = evaluate(wim.model, x, None, sigma_state=sigma_state, L=L,
                   decode_mean=False, generator=generator)
    after = generator.get_state()
    generator.set_state(replay)
    alt = evaluate(wim.model, x, None, sigma_state=sigma_state, L=L,
                   decode_mean=False, generator=generator,
                   prior_override=wim.alternate)
    generator.set_state(after)
    losses = dict(out.losses)
    losses.update({k + '@': v for k, v in alt.losses.items()
                   if not k.endswith('~')})
    return out.logits, losses


@pytest.mark.parametrize('L', [None, 5])
def test_one_draw_equals_the_two_call_reference(L, tmp_path):
    _, tjob, _ = _jobs(tmp_path)
    tw = twim.WIMJob(job=tjob)
    tw.set_alternate_prior(init_mean=8.0, num_priors=1, seed=3)
    x = torch.from_numpy(_x(7))
    g, h = make_generator('cpu', 21), make_generator('cpu', 21)
    for _ in range(2):
        _, logits, losses, _ = tw.evaluate_on_both_priors(
            x, sigma_state=tjob.sigma_state, L=L, decode_mean=False,
            generator=g)
        want_logits, want = _two_call_reference(tw, x, tjob.sigma_state, h, L)
        _same(logits, want_logits)
        _same(losses, want)
        _same(g.get_state(), h.get_state())


@pytest.mark.parametrize('type_,dtype', [('cvae', 'float32'),
                                         ('cvae', 'bfloat16'),
                                         ('jvae', 'float32')])
def test_draw_eval_epsilon_is_evaluates_draw(type_, dtype):
    cfg = CVNetConfig(input_shape=(1, 6, 6), num_labels=3, type=type_,
                      y_is_coded=type_ == 'jvae',
                      encoder=(12,), decoder=(12,), latent_dim=4,
                      test_latent_sampling=3, compute_dtype=dtype,
                      prior=PriorConfig(dim=4, num_priors=3))
    job = tjobs.new_job(cfg, seed=1, device='cpu')
    x = torch.rand(5, *cfg.input_shape, generator=torch.Generator()
                   .manual_seed(0))
    g, h = make_generator('cpu', 4), make_generator('cpu', 4)
    a = evaluate(job.model, x, None, sigma_state=job.sigma_state,
                 generator=g)
    eps = draw_eval_epsilon(cfg, 5, generator=h)
    assert eps.shape == ((4,) + ((3,) if type_ == 'jvae' else ())
                         + (5, 4))
    assert not eps[0].any() and eps.dtype == cfg.dtype
    b = evaluate(job.model, x, None, sigma_state=job.sigma_state, eps=eps)
    _same({k: v for k, v in a.losses.items()},
          {k: v for k, v in b.losses.items()})
    _same(a.logits, b.logits)
    _same(g.get_state(), h.get_state())


def test_score_graph_buffers_owners_and_counts():
    """On the CPU the body reads one set of static buffers per input
    shapes (a copy of the input in them); a new generator or owner drops
    them; ``batches_run`` counts each graph's batches by name;
    ``graphed=False`` runs the body on the inputs as given."""
    seen = []

    def body(generator, x, y=None):
        seen.append(x.data_ptr())
        out = {'s': x.sum(-1) + torch.randn(x.shape[0], generator=generator)}
        if y is not None:
            out['y'] = y * 2
        return out
    reset_steps_run()
    g = ScoreGraph(body, name='t')
    gen = torch.Generator().manual_seed(0)
    xs = torch.arange(24.0).reshape(6, 4)
    a = g(gen, x=xs[:3])
    b = g(gen, x=xs[3:])
    c = g(gen, x=xs[:2], y=torch.ones(2))
    assert seen[0] == seen[1] != seen[2]
    assert len(g._entries) == 2 and set(c) == {'s', 'y'}
    assert not torch.equal(a['s'], b['s'])
    g(torch.Generator().manual_seed(0), x=xs[:3])
    assert len(g._entries) == 1
    g(gen, x=xs[:3], owner=(object(),))
    assert len(g._entries) == 1
    assert batches_run == {'t': {'eager': 5, 'captured': 0, 'replayed': 0}}
    assert steps_run == {'eager': 0, 'captured': 0, 'replayed': 0}
    e = ScoreGraph(body, name='u', graphed=False)
    x = xs[:3].clone()
    e(gen, x=x)
    assert seen[-1] == x.data_ptr() and len(e._entries) == 0
    assert batches_run['u'] == {'eager': 1, 'captured': 0, 'replayed': 0}
    reset_steps_run()
    assert batches_run == {}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('geom', [(4, 64, 8, 200, 7, 1, 0),
                                  (3, 32, 12, 32, 5, 2, 2)],
                         ids=['conv_4', 'strided'])
def test_deterministic_conv_is_conv2d_on_the_cpu(geom, dtype):
    n, ci, h, co, k, s, p = geom
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, h, h, ci, generator=g).to(dtype).permute(0, 3, 1, 2)
    w = torch.randn(co, ci, k, k, generator=g).to(dtype)
    gy = None
    grads = []
    for fn in (lambda a, b: F.conv2d(a, b, stride=s, padding=p),
               lambda a, b: DeterministicConvFn.apply(a, b, s, p)):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(a, b)
        gy = torch.randn(y.shape, generator=g).to(dtype) if gy is None else gy
        grads.append((y.detach(),) + torch.autograd.grad(y, [a, b], gy))
    for u, v in zip(*grads):
        assert torch.equal(u, v)
    assert not torch.backends.cudnn.deterministic


def test_recorder_tier_after_a_graphed_compute_tier_runs_no_batch(
        tmp_path, shared_noise):
    """The recorder tier after a graphed compute tier reads the record
    files it wrote: no batch runs."""
    jjob, tjob, d = _jobs(tmp_path)
    tts = _sets(40, 1, 'test', C)[1]
    to1 = _sets(24, 2, 'ooda', C)[1]
    teng.ood_detection_rates(tjob, tts, [to1], batch_size=BATCH,
                             method=list(METHODS))
    assert any('test' in f for f in _record_bytes(d))
    reset_steps_run()
    tjob.ood_results.clear()
    teng.ood_detection_rates(tjob, tts, [to1], batch_size=BATCH,
                             method=list(METHODS),
                             from_where=('recorders',))
    assert batches_run == {}
