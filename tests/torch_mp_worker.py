"""Ranks of the port's multi-process tests: ``launch`` spawns one process
per rank of a gloo world on a free localhost port; each rank runs a case
of this module on the CPU and pickles what it measured.

Usage (per rank): python tests/torch_mp_worker.py <case> <rank> <world>
<port> <outdir>; the case's arguments are in <outdir>/args.pkl and rank
r writes <outdir>/<case>-<r>.pkl.  Each rank has its own time limit in
``launch`` and a hung or failed rank fails the launch.
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def launch(case: str, world: int, outdir: str, timeout: float = 120.0,
           **kwargs):
    """Run ``case`` on ``world`` ranks; returns the ranks' results (a list
    indexed by rank).  Raises with the ranks' output when a rank fails or
    runs past ``timeout`` seconds."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, 'args.pkl'), 'wb') as f:
        pickle.dump(kwargs, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get('PYTHONPATH', ''), OMP_NUM_THREADS='1')
    logs = [open(os.path.join(outdir, '{}-{}.log'.format(case, r)), 'w+')
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
         str(port), outdir], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env, cwd=outdir) for r in range(world)]
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = []
        for r in bad:
            logs[r].seek(0)
            text.append('rank {} (exit {}):\n{}'.format(
                r, procs[r].returncode, logs[r].read()[-4000:]))
        raise RuntimeError('{} failed:\n{}'.format(case, '\n'.join(text)))
    for f in logs:
        f.close()
    out = []
    for r in range(world):
        with open(os.path.join(outdir, '{}-{}.pkl'.format(case, r)),
                  'rb') as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# shared inputs (the tests build the same ones in-process)
# ---------------------------------------------------------------------------

def data(n, seed, shape=(1, 6, 6), classes=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    base = np.linspace(0.2, 0.8, classes)[y].reshape((n,) + (1,) * len(shape))
    x = np.clip(base + 0.1 * rng.standard_normal((n,) + tuple(shape)),
                0, 1).astype(np.float32)
    return x, y


def dataset(n, seed, name='blobs', **kw):
    from joint_vae_tpu_torch.data.loaders import ArrayDataset
    x, y = data(n, seed, **kw)
    return ArrayDataset(x, y, name)


def zero_noise():
    """Sample with eps = 0 (z = mu) in the port, as the JAX comparison
    does on its side."""
    import torch
    import joint_vae_tpu_torch.models.evaluate as ev

    def fake(mu, log_var, L, dist='gaussian', sampled=True, *, eps=None,
             generator=None):
        return (mu[None].expand((L + 1,) + mu.shape),
                torch.zeros((L,) + mu.shape, dtype=mu.dtype,
                            device=mu.device))
    ev.reparameterize = fake


# ---------------------------------------------------------------------------
# cases: f(mesh_args, **kwargs) -> picklable result
# ---------------------------------------------------------------------------

def _mesh(kw):
    from joint_vae_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(model_axis=kw.get('model_axis', 1),
                     sample_axis=kw.get('sample_axis', 1),
                     device='cpu')


def _history(job):
    return {e: job.train_history[e] for e in job.train_history
            if isinstance(e, int)}


def case_train(kw):
    """``train_model`` on the mesh from a job dir; per-step metrics, the
    history, the whole weights after training, and the collectives run
    by the train steps."""
    import torch.distributed as dist
    from joint_vae_tpu_torch.parallel.mesh import split_names
    from joint_vae_tpu_torch.save_load.jobs import load_job, save_job
    from joint_vae_tpu_torch.train import trainer
    from joint_vae_tpu_torch.utils.print_log import EpochOutput
    if kw.get('zero_noise'):
        zero_noise()
    mesh = _mesh(kw)
    job = load_job(kw['job_dir'], device='cpu')
    if kw.get('opt'):
        import dataclasses
        job.opt_cfg = dataclasses.replace(job.opt_cfg, **kw['opt'])
    steps, calls = [], []
    make = trainer.make_train_step
    real = dist.all_reduce

    def counting(t, *a, group=None, **k):
        calls.append(dist.get_process_group_ranks(group)
                     if group is not None else 'world')
        return real(t, *a, group=group, **k)

    def recording(*a, **k):
        step = make(*a, **k)

        def run(state, x, y, eps=None):
            n0 = len(calls)
            dist.all_reduce = counting
            try:
                state, m = step(state, x, y, eps)
            finally:
                dist.all_reduce = real
            steps.append(({k_: float(v) for k_, v in m.items()},
                          calls[n0:]))
            return state, m
        return run
    trainer.make_train_step = recording
    refused = None
    try:
        if kw.get('refuse'):
            try:
                trainer.train_model(job, dataset(16, 1), None, epochs=1,
                                    batch_size=16)
            except ValueError as e:
                refused = str(e)
        shape = tuple(kw.get('shape', (1, 6, 6)))
        trainer.train_model(job, dataset(kw['n_train'], 1, shape=shape,
                                         classes=kw.get('classes', 4)),
                            None,
                            epochs=kw['epochs'], batch_size=kw['batch_size'],
                            test_batch_size=kw.get('test_batch_size', 16),
                            outputs=EpochOutput(stdout=False), seed=3,
                            final_test=False, final_ood=False, mesh=mesh)
    finally:
        trainer.make_train_step = make
    out = {'steps': steps, 'history': _history(job),
           'split': sorted(split_names(job.model)),
           'weights': weights(job.model, mesh), 'refused': refused,
           'buffers': {n: b.numpy() for n, b in job.model.named_buffers()}}
    if kw.get('save'):
        import json
        real_dump, writes = json.dump, []
        json.dump = lambda *a, **k: writes.append(1) or real_dump(*a, **k)
        try:
            save_job(job, os.path.join(kw['save'], 'job'))
        finally:
            json.dump = real_dump
        out['json_writes'] = len(writes)
    return out


def weights(model, mesh=None):
    """The whole parameters {name: array}, the class-split ones gathered
    over 'model' (every rank must call it)."""
    from joint_vae_tpu_torch.parallel.mesh import host_get, split_names
    split = split_names(model)
    return {n: host_get(p, _model_sharding(mesh, p.ndim) if n in split
                        else None)
            for n, p in model.named_parameters()}


def _model_sharding(mesh, ndim):
    from joint_vae_tpu_torch.parallel.mesh import Sharding
    return Sharding(mesh, ('model',) + (None,) * (ndim - 1))


def case_ood(kw):
    """``ood_detection_rates`` on the mesh for each of ``kw['runs']`` (a
    dict each: the mesh axes, ``batch_size``, one set of ``n_test``
    in-distribution and one of ``n_ood`` OOD images), after a placement
    of the state; {run name: the results and that run's warning log}.
    ``kw['shape']`` and ``kw['classes']``: the images' shape and the
    labels' range (tests/test_parallel.py's by default)."""
    import logging
    from joint_vae_tpu_torch.evals.engines import ood_detection_rates
    from joint_vae_tpu_torch.parallel.mesh import ensure_placed
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.train.state import make_generator
    records = []

    class H(logging.Handler):
        def emit(self, rec):
            records.append(rec.getMessage())
    logging.getLogger().addHandler(H())
    out = {}
    for name, run in kw['runs'].items():
        n0 = len(records)
        mesh = _mesh(run)
        job = load_job(kw['job_dir'], device='cpu')
        job.state = ensure_placed(job.state, mesh)
        sets = dict(shape=tuple(kw.get('shape', (1, 6, 6))),
                    classes=kw.get('classes', 4))
        ood = dataset(run['n_ood'], 9, name='noise', **sets)
        res = ood_detection_rates(
            job, dataset(run['n_test'], 2, **sets), [ood],
            batch_size=run['batch_size'], recording=False,
            from_where=('compute',), generator=make_generator('cpu', 5),
            mesh=mesh)
        out[name] = {'results': res, 'log': records[n0:]}
    return out


def case_ckpt(kw):
    """Restore a sharded job dir onto this mesh, train a step, and save
    it again (synchronously or through an AsyncCheckpointer)."""
    from joint_vae_tpu_torch.save_load.jobs import load_job, save_job
    from joint_vae_tpu_torch.save_load.sharded_checkpoint import (
        AsyncCheckpointer)
    from joint_vae_tpu_torch.train import trainer
    from joint_vae_tpu_torch.utils.print_log import EpochOutput
    mesh = _mesh(kw)
    job = load_job(kw['job_dir'], device='cpu')
    trainer.train_model(job, dataset(kw['n_train'], 1), None,
                        epochs=job.trained + 1, batch_size=kw['batch_size'],
                        outputs=EpochOutput(stdout=False), seed=3,
                        mesh=mesh)
    ck = AsyncCheckpointer() if kw.get('async') else None
    save_job(job, kw['out_dir'], checkpointer=ck)
    if ck is not None:
        ck.wait()
        from joint_vae_tpu_torch.save_load.sharded_checkpoint import barrier
        barrier()
    return {'history': _history(job)}


def case_wim(kw):
    """WIM ``finetune`` and Poscod on the mesh (the test runs the same on
    one process)."""
    from joint_vae_tpu_torch.ft.job import finetune, load_wim_job
    from joint_vae_tpu_torch.ft.poscod import PoscodJob
    from joint_vae_tpu_torch.save_load.jobs import load_job
    mesh = _mesh(kw)
    return run_wim(kw, mesh, load_wim_job, finetune, PoscodJob, load_job)


def run_wim(kw, mesh, load_wim_job, finetune, PoscodJob, load_job):
    """The WIM and Poscod flows of ``case_wim``, shared with the test's
    one-process run."""
    wim = load_wim_job(kw['job_dir'], device='cpu', distribution='gaussian',
                       mean_shift=0.5, seed=2)
    train, test = dataset(64, 1), dataset(32, 2)
    moving, ood = dataset(32, 5, name='moving'), dataset(32, 9, name='noise')
    finetune(wim, train, moving, test, [ood], epochs=1, alpha=0.1,
             batch_size=16, test_batch_size=16, seed=4, mesh=mesh)
    job = wim.job
    w = weights(job.model, mesh)
    pc = PoscodJob(job=load_job(kw['job_dir'], device='cpu'))
    pc.finetune(test, moving, epochs=1, batch_size=16, seed=1, mesh=mesh)
    llr = pc.llr_scores(ood, batch_size=16, mesh=mesh)
    return {'ood': job.ood_results, 'testing': job.testing, 'weights': w,
            'llr': llr, 'head': {k: v.numpy() for k, v in pc.head.items()}}


def _entry_keys(graph) -> list:
    """A graph's entries as (scope's (rows, samples) or None, input
    shapes), in the order they were made."""
    return [(None if sc is None else (sc.rows, sc.samples),
             tuple((k, shape) for k, shape, _, _ in inputs))
            for sc, inputs in graph._entries]


def case_graphs(kw):
    """The mesh programs graphed (on the CPU their bodies run on the
    graphs' static buffers) and eager (``graphed=False``): ``train_model``
    on a (2, 2) mesh with the generator's noise, graphed with zero noise
    too; WIM ``finetune``; ``ood_detection_rates`` at model_axis=2 and at
    sample_axis=2 (data 2 both) and the per-epoch mean losses, each on
    sets whose batches of 6 run split over 'data' (3 rows a rank) before
    a tail of 3 that runs whole."""
    import joint_vae_tpu_torch.models.evaluate as ev
    from joint_vae_tpu_torch.evals.engines import ood_detection_rates
    from joint_vae_tpu_torch.ft.job import finetune, load_wim_job
    from joint_vae_tpu_torch.parallel.mesh import ensure_placed
    from joint_vae_tpu_torch.save_load.jobs import load_job
    from joint_vae_tpu_torch.train import trainer
    from joint_vae_tpu_torch.train.graphs import held_score_graphs
    from joint_vae_tpu_torch.train.state import make_generator
    from joint_vae_tpu_torch.utils.print_log import EpochOutput
    out = {}
    mesh = _mesh({'model_axis': 2})
    real_draw, make = ev.reparameterize, trainer.make_train_step
    for name, graphed in (('eager', False), ('graph', True),
                          ('graph_zero_noise', True)):
        if name == 'graph_zero_noise':
            zero_noise()
        job = load_job(kw['job_dir'], device='cpu')
        steps, made = [], []

        def recording(*a, **k):
            step = make(*a, **k)
            made.append(step)

            def run(state, x, y, eps=None):
                state, m = step(state, x, y, eps)
                steps.append({k_: float(v) for k_, v in m.items()})
                return state, m
            return run
        trainer.make_train_step = recording
        try:
            trainer.train_model(job, dataset(kw['n_train'], 1), None,
                                epochs=kw['epochs'],
                                batch_size=kw['batch_size'],
                                outputs=EpochOutput(stdout=False), seed=3,
                                final_test=False, final_ood=False,
                                mesh=mesh, graphed=graphed)
        finally:
            trainer.make_train_step = make
            ev.reparameterize = real_draw
        out['train_' + name] = {
            'steps': steps, 'history': _history(job),
            'weights': weights(job.model, mesh),
            'graphed': made[0].graph.graphed,
            'entries': len(made[0].graph._entries)}

    test, ood = dataset(15, 2), dataset(15, 9, name='noise')
    for name, graphed in (('eager', False), ('graph', True)):
        wim = load_wim_job(kw['job_dir'], device='cpu',
                           distribution='gaussian', mean_shift=0.5, seed=2)
        finetune(wim, dataset(64, 1), dataset(32, 5, name='moving'),
                 dataset(32, 2), [dataset(32, 9, name='noise')], epochs=1,
                 alpha=0.1, batch_size=16, test_batch_size=16, seed=4,
                 mesh=mesh, graphed=graphed)
        out['wim_' + name] = {'ood': wim.job.ood_results,
                              'weights': weights(wim.job.model, mesh)}

        job = load_job(kw['job_dir'], device='cpu')
        job.state = ensure_placed(job.state, mesh)
        out['losses_' + name] = trainer._mean_losses(
            job, test, 6, 0, mesh=mesh, graphed=graphed)
        if graphed:
            out['losses_entries'] = _entry_keys(
                held_score_graphs(job)['mean_losses'])

        for axes in ({'model_axis': 2}, {'sample_axis': 2}):
            m = _mesh(axes)
            job = load_job(kw['job_dir'], device='cpu')
            job.state = ensure_placed(job.state, m)
            key = 'ood_model2' if 'model_axis' in axes else 'ood_sample2'
            out[key + '_' + name] = ood_detection_rates(
                job, test, [ood], batch_size=6, recording=False,
                from_where=('compute',), generator=make_generator('cpu', 5),
                mesh=m, graphed=graphed)
            if graphed:
                out[key + '_entries'] = _entry_keys(
                    held_score_graphs(job)['ood'])
    return out


def case_im64(kw):
    """imagenet64 on the mesh: ``case_ood`` on the narrowed twin's job
    (``kw['ood']``), ``case_train`` on it at each of ``kw['train']`` (a
    dict of mesh axes per run), and one train step of the full-width
    model made by ``new_job(imagenet64_config(), seed=kw['full_seed'])``
    on a (data 1, model 2) mesh on ``kw['full']``'s batch and injected
    noise, its metrics and this rank's prior block's shape."""
    import torch
    from joint_vae_tpu_torch.models.cvnet import imagenet64_config
    from joint_vae_tpu_torch.parallel.mesh import ensure_placed
    from joint_vae_tpu_torch.save_load.jobs import new_job
    from joint_vae_tpu_torch.train.steps import make_train_step
    sets = {k: kw[k] for k in ('job_dir', 'shape', 'classes')}
    out = {'ood': case_ood(dict(sets, runs=kw['ood']))}
    for name, axes in kw['train'].items():
        out['train_' + name] = case_train(dict(sets, **kw['train_args'],
                                               **axes))
    full = kw['full']
    mesh = _mesh({'model_axis': 2})
    job = new_job(imagenet64_config(), seed=kw['full_seed'], device='cpu')
    job.state = ensure_placed(job.state, mesh)
    step = make_train_step(job.model, job.opt_cfg, mesh=mesh)
    _, m = step(job.state, torch.from_numpy(full['x']),
                torch.from_numpy(full['y']), torch.from_numpy(full['eps']))
    out['full_step'] = {
        'metrics': {k: float(v) for k, v in m.items()},
        'prior_mean_block': tuple(job.model.get_parameter(
            'prior.mean').shape)}
    return out


CASES = {'train': case_train, 'ood': case_ood, 'ckpt': case_ckpt,
         'wim': case_wim, 'graphs': case_graphs, 'im64': case_im64}


def main(argv):
    case, rank, world, port, outdir = argv
    import torch
    torch.set_num_threads(1)
    from joint_vae_tpu_torch.parallel.mesh import distributed_init
    distributed_init('localhost:{}'.format(port), int(world), int(rank),
                     backend='gloo')
    with open(os.path.join(outdir, 'args.pkl'), 'rb') as f:
        kw = pickle.load(f)
    out = CASES[case](kw)
    with open(os.path.join(outdir, '{}-{}.pkl'.format(case, rank)),
              'wb') as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1:])
