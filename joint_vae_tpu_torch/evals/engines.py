"""Accuracy / OOD / misclassification engines.

Port of ``joint_vae_tpu/evals/engines.py``:

- :func:`accuracy` (ref cvae.py:1187-1446): batched label-free evaluation,
  prediction per method, recorder capture, testing-results update.
- :func:`ood_detection_rates` (ref cvae.py:1455-1911): per-set scores, the
  ODIN grid for logit models, ROC per method with suffix-selected
  geometry, ood_results update with the reference's JSON schema
  {epochs, n, mean, std, auc, tpr, fpr, thresholds, thresholds_up,
  precision}.
- :func:`misclassification_detection_rates` (ref cvae.py:1913-2080):
  correct-vs-missed ROC per (predict method, misclass method) with
  precision/recall at kept TPRs.

Each engine reuses what it can, per (set, method), in three tiers:
stored json results with enough samples ('json'), record files under
``samples/<epoch>/`` holding the loss components a method needs
('recorders', no model forward), and a fresh evaluation ('compute').

The compute tier is one loop over the set's batches under
``torch.no_grad()`` (ODIN takes its input gradient inside): the per-class
evaluation without labels and without the mean sample's decode, then the
score measures.  Each batch is one scoring graph on the card
(``train/graphs.py::ScoreGraph``, the counterpart of the JAX engine's
``eval_batch``): the evaluation, ODIN where the methods ask for it and
the scores (``accuracy``: the predictions' correct counts), one graph for
the full batch and one for a ragged tail, replayed per batch; the
recorder gets copies of each batch's losses and logits.  The graphs and
their generator are held on the job across engine calls, one scoring
graph per engine (the OOD engine's scores the union of its sets'
methods), so that a capture is paid once per job and batch shape; each
call reseeds the generator.  Scores and
recorder tensors stay on the job's device and are pulled to the host
once per set; the ROC runs on the device.  The
latent noise comes from a generator seeded with the epoch (+1 for
accuracy, +2 for misclassification), as the JAX package keys its draws.
A bfloat16 model scores with the 'bf16' loss epilogue
(``models/evaluate.py`` ``native_scores``), the JAX engine's default for
bfloat16 models, so that its per-class scores follow the JAX engine's.
The JAX package's scan over stacks of 16 batches (one graph per batch
here) and its evaluation knobs (its ``JVT_EVAL_*`` environment) are not
ported.

``mesh=`` feeds the compute tier over a device mesh
(``parallel/mesh.py``): each batch that divides the 'data' axis runs as
this rank's rows (a tail goes in whole), the decode splits its samples
over 'sample', the classes are split over 'model' as the state is placed,
and the losses and logits are gathered back by rows, so that every rank
scores the whole set as the one-process run does.  A mesh-fed batch is
a scoring graph too (``train/graphs.py``), its collectives (the class
and sample gathers) captured and its entry keyed by the batch's mesh
scope; the gathers by rows run outside it, and a mesh over gloo on a
card runs eagerly.  A multi-process run
skips the recorder replay tier (one rank replaying while the others run
collectives would hang them); rank 0 writes the record files.
"""

import logging
import os
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.loaders import ArrayDataset, DataLoader, get_dataset
from ..device import to_device
from ..models.evaluate import evaluate
from ..ops.roc import DEFAULT_KEPT_TPR, roc_curve, two_sided_from_method
from ..ops.scores import (batch_dist_measures, develop_starred_methods,
                          predict_after_evaluate, strip_roc_suffix)
from ..parallel.mesh import eval_feed, world
from ..save_load.dictify import _fpr_at, needed_components
from ..save_load.jobs import Job
from ..save_load.checkpoint import is_write_process
from ..save_load.recorders import LossRecorder, find_record, record_filename
from ..train.graphs import ScoreGraph, held_graph, held_score_graphs  # noqa: F401
from .odin import make_odin_scores

KEPT_TPR = DEFAULT_KEPT_TPR
_ALL_TIERS = ('json', 'recorders', 'compute')


def _epoch_of(job: Job, epoch):
    return job.trained if epoch in (None, 'last') else int(epoch)


def _multiprocess_tiers(from_where):
    """A multi-process run keeps every rank on the same compute path: the
    recorder replay tier reads per-host files, and one rank replaying
    while the others run a collective-bearing forward would hang them.
    The json tier stays (the job's results are the same on every
    rank)."""
    if world()[0] > 1:
        return tuple(w for w in from_where if w != 'recorders')
    return tuple(from_where)


_LOGITS = '/logits'


def _rows(key: str, t: torch.Tensor) -> int:
    """The row axis of an evaluation output: losses (..., N), logits
    (..., N, C)."""
    return t.ndim - 2 if key == _LOGITS else t.ndim - 1


_LOSS, _SCORE, _CORRECT = 'loss/', 'score/', 'correct/'


def _split_losses(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[len(_LOSS):]: v for k, v in out.items() if k.startswith(_LOSS)}


def _is_wim_method(m: str) -> bool:
    """'~'/'@'-suffixed methods need the WIM twin recordings (alternate
    prior losses / estimated labels, ref ft/wim.py): a plain evaluate
    cannot produce them, so they are recorder/json-tier only."""
    b = strip_roc_suffix(m)
    return bool(b) and b[-1] in '~@'


def _sample_dir(job: Job, epoch: int) -> Optional[str]:
    if not job.saved_dir:
        return None
    return os.path.join(job.saved_dir, 'samples', '{:04d}'.format(epoch))


def _make_odin(job: Job, methods: Sequence[str]):
    """The ODIN pass restricted to the (T, eps) pairs the methods need (the
    full reference grid is 10x21), or None."""
    if not any(m.startswith('odin') for m in methods):
        return None
    temps, eps = set(), set()
    for m in methods:
        if m.startswith('odin-'):
            parts = m.split('-')
            temps.add(float(parts[1]))
            eps.add(float(parts[2]))
    return make_odin_scores(job.model, temps=sorted(temps) or None,
                            eps_grid=sorted(eps) or None)


def _pull_rows(rows: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Equal-length 1-D device tensors -> host arrays, in one copy."""
    if not rows:
        return {}
    host = torch.stack(list(rows.values())).cpu().numpy()
    return dict(zip(rows, host))


def _rev(t: torch.Tensor) -> torch.Tensor:
    """All axes reversed (numpy's ``.T``)."""
    return t.permute(*range(t.ndim - 1, -1, -1))


def _fill_recorder(recorder: LossRecorder, batches):
    """Append the per-batch (losses, logits, y) of a set, each key's
    tensors concatenated on the device and pulled once; logits are stored
    transposed (C, N) as the JAX package stores them.  A bfloat16 model's
    logits are stored as float32, which holds them exactly (the JAX
    package writes their raw 2-byte words, which read back as numpy's
    void type)."""
    keys = list(batches[0][0])
    host = {k: torch.cat([b[0][k] for b in batches], dim=-1).cpu().numpy()
            for k in keys}
    logits = torch.cat([_rev(b[1]) for b in batches], dim=-1)
    host['logits'] = (logits.float() if logits.dtype == torch.bfloat16
                      else logits).cpu().numpy()
    start = 0
    for _, _, y in batches:
        n = len(y)
        rec = {k: v[..., start:start + n] for k, v in host.items()}
        rec['y_true'] = np.asarray(y)
        recorder.append_batch(**rec)
        start += n


def _score_graph(job: Job, methods: Sequence[str], mesh=None,
                 graphed: bool = True) -> ScoreGraph:
    """The compute tier's batch (the JAX engine's ``eval_batch``): the
    evaluation, ODIN (if the methods ask for it) and, off a mesh, the
    scores, as a scoring graph (``graphed=False``: eager); on a mesh the
    callers score the gathered rows."""
    cfg = job.model_cfg
    # the JAX engine's default epilogue (engines.py:123-126)
    native = 'bf16' if cfg.compute_dtype == 'bfloat16' else False
    odin = _make_odin(job, methods)
    ref = weakref.ref(job)          # the job holds the graph

    def body(generator, x):
        job = ref()
        out = evaluate(job.model, x, None, sigma_state=job.sigma_state,
                       train=False, decode_mean=False, native_scores=native,
                       generator=generator)
        losses = dict(out.losses)
        if odin is not None:
            losses.update(odin(x, generator))
        res = {_LOSS + k: v for k, v in losses.items()}
        res[_LOGITS] = out.logits
        if mesh is None:
            with torch.no_grad():
                res.update({_SCORE + m: v for m, v in batch_dist_measures(
                    cfg, out.logits, losses, methods).items()})
        return res
    return ScoreGraph(body, name='score_batch', graphed=graphed)


def _collect_scores(job: Job, dataset: ArrayDataset, methods: Sequence[str],
                    batch_size: int, recorder: Optional[LossRecorder],
                    graph: ScoreGraph, generator: torch.Generator,
                    num_batch: Optional[int] = None,
                    mesh=None) -> Dict[str, torch.Tensor]:
    """Run the model over a dataset through ``graph`` (:func:`_score_graph`
    of these methods or more); returns {method: (N,)} scores on the job's
    device and fills ``recorder`` (if any) with the set's losses."""
    cfg = job.model_cfg
    put, run = eval_feed(mesh, job.device, 1 + len(dataset.shape))
    loader = DataLoader(dataset, batch_size, shuffle=False,
                        seed=((recorder.restore_seed() or 0)
                              if recorder is not None else 0),
                        drop_last=False)
    per_method: Dict[str, List[torch.Tensor]] = {m: [] for m in methods}
    rec_batches = []
    for i, (x, y) in enumerate(loader):
        if num_batch is not None and i >= num_batch:
            break
        xt = put(x)
        out = run(len(x), lambda: graph(generator, x=xt), _rows)
        losses, logits = _split_losses(out), out[_LOGITS]
        if mesh is None:
            scores = {m: out[_SCORE + m] for m in methods}
        else:
            with torch.no_grad():
                scores = batch_dist_measures(cfg, logits, losses, methods)
        for m in methods:
            per_method[m].append(scores[m])
        if recorder is not None:
            rec_batches.append((losses, logits, y))
    if recorder is not None and rec_batches:
        _fill_recorder(recorder, rec_batches)
    return {m: torch.cat(v) for m, v in per_method.items()}


def _recorder_tensors(recorder: LossRecorder, device: torch.device):
    """(losses, logits, y_true) from a recorder, the tensors on ``device``,
    undoing the stored logits transpose — the one place that knows the
    layout."""
    def put(a):
        # a .jvr recorder's arrays are read-only views of its memory map
        return torch.from_numpy(np.array(a)).to(device)
    losses = {k: put(recorder.get(k)) for k in recorder.keys()
              if k not in ('logits', 'y_true')}
    logits = _rev(put(recorder.get('logits'))) if 'logits' in recorder else None
    y_true = (np.asarray(recorder.get('y_true'))
              if 'y_true' in recorder else None)
    return losses, logits, y_true


def _scores_from_recorder(job: Job, recorder: LossRecorder,
                          methods: Sequence[str]) -> Dict[str, torch.Tensor]:
    losses, logits, _ = _recorder_tensors(recorder, job.device)
    return batch_dist_measures(job.model_cfg, logits, losses, methods)


def _save_recorder(rec: LossRecorder, path: str):
    """Never degrade a stored recorder (ref recorders accumulate per epoch
    dir): keep the old file when it holds more samples; fold old-only keys
    in when the sample counts match.  Rank 0 writes; in a multi-process
    run a tie keeps the old tensors (the replay tier is off there, so a
    later engine recomputes what one process would have replayed), with
    the new-only keys folded in, so that the record files do not depend
    on the process count."""
    if not is_write_process():
        return
    base = path[:-4]  # same set stored in either format counts
    for ext in ('.jvr', '.npz'):
        p = base + ext
        if not os.path.exists(p):
            continue
        try:
            old = LossRecorder.load(p)
        except (OSError, ValueError, KeyError) as e:
            logging.warning('unreadable record file %s (%s): replaced', p, e)
            continue
        if old.recorded_samples > rec.recorded_samples:
            logging.info('keeping %s (%d > %d recorded samples)', p,
                         old.recorded_samples, rec.recorded_samples)
            return
        if old.recorded_samples == rec.recorded_samples:
            if world()[0] > 1:
                for k in rec.keys():
                    if k not in old:
                        old._tensors[k] = rec.get(k)
                rec = old
            else:
                for k in old.keys():
                    if k not in rec:
                        rec._tensors[k] = old.get(k)
    rec.save(path)
    # the saved file supersedes any other-format twin (keys folded in
    # above); remove it so find_record's newest-wins rule can't resurrect
    # the stale one after an mtime-mangling copy of the job dir
    other = base + ('.npz' if path.endswith('.jvr') else '.jvr')
    if os.path.exists(other):
        try:
            os.remove(other)
        except OSError:
            pass


def _roc_entry(ins: torch.Tensor, outs: torch.Tensor, method: str) -> dict:
    """ROC of one (set, method) on the device, its arrays pulled in one
    copy: auc, fpr, thresholds (low, up) and precision at KEPT_TPR."""
    r = roc_curve(ins, outs, kept_tpr=KEPT_TPR,
                  two_sided=two_sided_from_method(method))
    k = len(KEPT_TPR)
    flat = torch.cat([r['auc'].reshape(1), r['fpr'], r['thresholds_low'],
                      r['thresholds_up'], r['precision']]).cpu().numpy()
    parts = [flat[1 + i * k:1 + (i + 1) * k].tolist() for i in range(4)]
    return {'auc': float(flat[0]), 'fpr': parts[0], 'thresholds': parts[1],
            'thresholds_up': parts[2], 'precision': parts[3]}


def ood_detection_rates(job: Job, testset: Optional[ArrayDataset] = None,
                        oodsets: Optional[Sequence[ArrayDataset]] = None,
                        batch_size: int = 100,
                        num_batch: Optional[int] = None,
                        method='all',
                        epoch='last',
                        update_self_ood: bool = True,
                        recording: bool = True,
                        record_dir: Optional[str] = None,
                        from_where: Sequence[str] = _ALL_TIERS,
                        generator: Optional[torch.Generator] = None,
                        outputs=None,
                        mesh=None,
                        graphed: Optional[bool] = None
                        ) -> Dict[str, Dict[str, dict]]:
    """OOD scores + ROC for the test set against each OOD set.

    Per-(set, method) 3-tier reuse (ref available_results dictify.py:215-382
    consumed by cvae.py:1455-1620): a method whose stored json already covers
    the wanted sample count is returned as-is; one whose needed loss
    components sit in a recorder is re-scored without model forwards; only
    the remainder triggers fresh evaluation — and the in-distribution scores
    are only computed for methods some OOD set still needs.  ``graphed``
    (default: True, but on a mesh over gloo on a card) scores each batch
    as a CUDA graph on the card, held on the job (module docstring);
    False runs the same body eagerly.
    """
    cfg = job.model_cfg
    epoch = _epoch_of(job, epoch)
    from_where = _multiprocess_tiers(from_where)
    methods = develop_starred_methods(
        cfg.ood_methods if method == 'all'
        else ([method] if isinstance(method, str) else list(method)))
    if not methods:
        return {}
    if testset is None:
        name = job.training_parameters.get('set') or 'cifar10'
        _, testset = get_dataset(name, splits=['test'])
    if oodsets is None:
        oodsets = []
        for n in testset.same_size:
            try:
                _, s = get_dataset(n, splits=['test'])
                oodsets.append(s)
            except (ValueError, FileNotFoundError) as e:
                logging.debug('skipping oodset %s: %s', n, e)

    sdir = _sample_dir(job, epoch)

    def n_wanted(s):
        n = len(s)
        return min(n, num_batch * batch_size) if num_batch else n

    # --- tier 1: stored json per (ood set, method) -------------------------
    stored = job.ood_results.get(epoch, {})
    json_ok: Dict[str, set] = {}
    for s in oodsets:
        per = stored.get(s.name, {}) if 'json' in from_where else {}
        json_ok[s.name] = {m for m in methods
                           if isinstance(per.get(m), dict)
                           and per[m].get('n', 0) >= n_wanted(s)}

    need: Dict[str, List[str]] = {
        s.name: [m for m in methods if m not in json_ok[s.name]]
        for s in oodsets}
    ind_methods = [m for m in methods
                   if any(m in ms for ms in need.values())]
    need[testset.name] = ind_methods

    all_sets = [testset] + list(oodsets)
    sets_to_score = [s for s in all_sets if need.get(s.name)]

    # --- tier 2: recorders per method; plan tier-3 residue -----------------
    measures: Dict[str, Dict[str, torch.Tensor]] = {}
    to_compute: List = []            # (dataset, [methods])
    for s in sets_to_score:
        wanted = need[s.name]
        rec_path = find_record(sdir, s.name) if sdir else None
        loaded = None
        if rec_path and 'recorders' in from_where:
            loaded = LossRecorder.load(rec_path)
        from_rec, residue = [], []
        for m in wanted:
            if (loaded is not None
                    and loaded.recorded_samples >= n_wanted(s)
                    and all(c in loaded for c in needed_components(m))):
                from_rec.append(m)
            elif _is_wim_method(m):
                logging.warning(
                    "method %s needs WIM twin recordings absent for %s — "
                    'skipped (the ft flow records them)', m, s.name)
            else:
                residue.append(m)
        if from_rec:
            measures[s.name] = _scores_from_recorder(job, loaded, from_rec)
        if residue and 'compute' in from_where:
            to_compute.append((s, residue))

    # --- tier 3: fresh evaluation for the residue --------------------------
    if to_compute:
        union = [m for m in methods
                 if any(m in ms for _, ms in to_compute)]
        graph, generator = held_graph(
            job, 'ood', lambda g: _score_graph(job, union, mesh, g),
            key=union, seed=epoch, generator=generator, mesh=mesh,
            graphed=graphed)
        for s, ms in to_compute:
            rec = None
            # record_dir redirects fresh recordings (the WIM pre-tuning
            # baseline writes samples/<epoch>/init/, ref ft/job.py:302-313)
            wdir = record_dir or sdir
            rec_path = (os.path.join(wdir, record_filename(s.name))
                        if wdir else None)
            if recording and rec_path:
                rec = LossRecorder(batch_size)
                rec.init_seed_for_dataloader(0)
            scored = _collect_scores(job, s, ms, batch_size, rec, graph,
                                     generator, num_batch, mesh=mesh)
            measures.setdefault(s.name, {}).update(scored)
            if rec is not None:
                _save_recorder(rec, rec_path)

    # --- assemble: ROC for fresh methods, stored entries for json-tier -----
    host = {s.name: _pull_rows(measures.get(s.name, {})) for s in oodsets}
    ind = measures.get(testset.name, {})
    results: Dict[str, Dict[str, dict]] = {}
    fresh: Dict[str, Dict[str, dict]] = {}
    for s in oodsets:
        results[s.name] = {}
        for m in json_ok[s.name]:
            results[s.name][m] = stored[s.name][m]
        ood_scores = measures.get(s.name, {})
        for m in need[s.name]:
            if m not in ind or m not in ood_scores:
                continue
            v = host[s.name][m]
            r = _roc_entry(ind[m], ood_scores[m], m)
            entry = {
                'epochs': epoch,
                # n counts the OOD samples (ref cvae.py:1886); the tier-1
                # reuse check compares it against n_wanted(oodset)
                'n': int(v.shape[0]),
                'mean': float(np.mean(v)),
                'std': float(np.std(v)),
                'auc': r['auc'],
                'tpr': [float(t) for t in KEPT_TPR],
                'fpr': r['fpr'],
                'thresholds': r['thresholds'],
                'thresholds_up': r['thresholds_up'],
                'precision': r['precision'],
            }
            results[s.name][m] = entry
            fresh.setdefault(s.name, {})[m] = entry
        if not results[s.name]:
            results.pop(s.name)
    if update_self_ood and fresh:
        job.ood_results.setdefault(epoch, {})
        for s_name, rs in fresh.items():
            job.ood_results[epoch].setdefault(s_name, {}).update(rs)
    if outputs is not None:
        # one grouped live row per OOD set (ref EpochOutput fpr columns)
        for s_name, rs in results.items():
            fpr95 = {m: _fpr_at(r, 0.95) for m, r in rs.items()
                     if isinstance(r, dict)}
            aucs = {m: r.get('auc') for m, r in rs.items()
                    if isinstance(r, dict)}
            outputs.results(0, 1, epoch, epoch,
                            preambule='ood:' + s_name,
                            accuracy={'auc:' + m: v
                                      for m, v in list(aucs.items())[:4]},
                            fpr={m: v for m, v in list(fpr95.items())[:4]
                                 if v is not None})
    return results


def _accuracy_graph(job: Job, pm: Sequence[str],
                    graphed: bool = True) -> ScoreGraph:
    """``accuracy``'s batch (the JAX engine's ``eval_batch``) with the
    predictions' correct counts when given the labels (a mesh counts them
    on the gathered rows), as a scoring graph."""
    cfg = job.model_cfg
    ref = weakref.ref(job)          # the job holds the graph

    def body(generator, x, y=None):
        job = ref()
        out = evaluate(job.model, x, None, sigma_state=job.sigma_state,
                       train=False, decode_mean=False, generator=generator)
        res = {_LOSS + k: v for k, v in out.losses.items()}
        res[_LOGITS] = out.logits
        if y is not None:
            for m in pm:
                res[_CORRECT + m] = torch.sum(predict_after_evaluate(
                    cfg, out.logits, out.losses, m) == y)
        return res
    return ScoreGraph(body, name='accuracy_batch', graphed=graphed)


def accuracy(job: Job, testset: Optional[ArrayDataset] = None,
             batch_size: int = 100,
             num_batch: Optional[int] = None,
             method='all',
             epoch='last',
             update_self_testing: bool = True,
             recording: bool = True,
             generator: Optional[torch.Generator] = None,
             from_where: Sequence[str] = _ALL_TIERS,
             outputs=None,
             mesh=None,
             graphed: Optional[bool] = None) -> Dict[str, float]:
    """Classification accuracy per predict method (ref cvae.py:1187-1446).

    3-tier per-method reuse: stored json with enough samples is returned
    as-is; a recorder holding the needed loss components is replayed
    (predictions recomputed from recorded tensors, zero model forwards, ref
    cvae.py:1268-1330); only the residue evaluates the model, each batch a
    CUDA graph on the card, held on the job (module docstring), unless
    ``graphed=False`` or on a mesh over gloo on a card."""
    cfg = job.model_cfg
    epoch = _epoch_of(job, epoch)
    from_where = _multiprocess_tiers(from_where)
    predict_methods = (cfg.predict_methods if method == 'all'
                       else ([method] if isinstance(method, str) else list(method)))
    if not predict_methods:
        return {}
    if testset is None:
        name = job.training_parameters.get('set') or 'cifar10'
        _, testset = get_dataset(name, splits=['test'])

    n_want = (min(len(testset), num_batch * batch_size) if num_batch
              else len(testset))
    acc: Dict[str, float] = {}

    # tier 1: stored json (ref available_results short-circuit, cvae.py:1241)
    stored = job.testing.get(epoch, {})
    if 'json' in from_where:
        for m in predict_methods:
            r = stored.get(m)
            if (isinstance(r, dict) and r.get('n', 0) >= n_want
                    and 'accuracy' in r):
                acc[m] = r['accuracy']
    remaining = [m for m in predict_methods if m not in acc]

    # tier 2: recorder replay (ref cvae.py:1268-1330)
    sdir = _sample_dir(job, epoch)
    rec_path = find_record(sdir, testset.name) if sdir else None
    if remaining and 'recorders' in from_where and rec_path:
        loaded = LossRecorder.load(rec_path)
        if loaded.recorded_samples >= n_want and 'y_true' in loaded:
            losses, logits, y_true = _recorder_tensors(loaded, job.device)
            replayed = {}
            for m in remaining:
                if m == 'already' or not all(
                        c in loaded for c in needed_components(m)):
                    continue
                y_ = predict_after_evaluate(cfg, logits, losses, m)
                replayed[m] = float((y_.cpu().numpy() == y_true).mean())
            if replayed and update_self_testing:
                job.testing.setdefault(epoch, {})
                for m, a in replayed.items():
                    prev = job.testing[epoch].get(m, {})
                    if len(y_true) >= prev.get('n', 0):
                        job.testing[epoch][m] = {
                            'n': int(len(y_true)), 'epochs': epoch,
                            'sampling': cfg.test_latent_sampling,
                            'accuracy': a}
            acc.update(replayed)
            remaining = [m for m in remaining if m not in acc]

    if not remaining or 'compute' not in from_where:
        return acc
    predict_methods = remaining

    dev = job.device
    put, run = eval_feed(mesh, dev, 1 + len(testset.shape))
    loader = DataLoader(testset, batch_size, shuffle=False, drop_last=False)
    n_total = 0
    rec = LossRecorder(batch_size) if (recording and sdir) else None

    # datasets carrying pseudo-labels feed the 'already' method
    # (ref EstimatedLabelsDataset + y_est_already, ft/job.py:70-105)
    estimated = getattr(testset, 'estimated', None)

    pm = [m for m in predict_methods if m != 'already']
    graph, generator = held_graph(
        job, 'accuracy', lambda g: _accuracy_graph(job, pm, g), key=pm,
        seed=epoch + 1, generator=generator, mesh=mesh, graphed=graphed)
    counts = torch.zeros(len(pm), dtype=torch.int64, device=dev)
    rec_batches = []
    for i, (x, y) in enumerate(loader):
        if num_batch is not None and i >= num_batch:
            break
        xt = put(x)
        yt = to_device(y, dev)
        out = run(len(x), lambda: graph(
            generator, x=xt, y=yt if mesh is None else None), _rows)
        losses, logits = _split_losses(out), out[_LOGITS]
        with torch.no_grad():
            for j, m in enumerate(pm):
                counts[j] += (out[_CORRECT + m] if mesh is None
                              else torch.sum(predict_after_evaluate(
                                  cfg, logits, losses, m) == yt))
        n_total += len(y)
        if rec is not None:
            rec_batches.append((losses, logits, y))

    n_correct = {m: int(c) for m, c in zip(pm, counts.cpu().numpy())}
    if estimated is not None and 'already' in predict_methods:
        n_correct['already'] = int((np.asarray(estimated[:n_total])
                                    == testset.targets[:n_total]).sum())
    if rec is not None and rec_batches:
        _fill_recorder(rec, rec_batches)
        _save_recorder(rec, os.path.join(sdir, record_filename(testset.name)))

    computed = {m: n_correct[m] / max(n_total, 1) for m in predict_methods
                if m != 'already' or estimated is not None}
    if outputs is not None and computed:
        outputs.results(0, 1, epoch, epoch, preambule='test',
                        accuracy=computed)
    if update_self_testing:
        job.testing.setdefault(epoch, {})
        for m in computed:
            prev = job.testing[epoch].get(m, {})
            if n_total >= prev.get('n', 0):
                job.testing[epoch][m] = {
                    'n': n_total, 'epochs': epoch,
                    'sampling': cfg.test_latent_sampling,
                    'accuracy': computed[m]}
    acc.update(computed)
    return acc


def misclassification_detection_rates(job: Job,
                                      testset: Optional[ArrayDataset] = None,
                                      predict_methods='all',
                                      misclass_methods='all',
                                      epoch='last',
                                      shown_tpr: float = 0.95,
                                      batch_size: int = 100,
                                      num_batch: Optional[int] = None,
                                      update_self_results: bool = True,
                                      generator: Optional[torch.Generator] = None,
                                      from_where: Sequence[str] = (
                                          'recorders', 'compute'),
                                      outputs=None,
                                      mesh=None,
                                      graphed: Optional[bool] = None
                                      ) -> Dict[str, dict]:
    """Detect misclassifications by thresholding confidence scores
    (ref cvae.py:1913-2080).  The recorder tier replays recorded tensors
    without model forwards (ref from_where=('json', 'recorders'));
    ``mesh`` and ``graphed`` feed the compute tier as in
    :func:`ood_detection_rates`."""
    cfg = job.model_cfg
    from_where = _multiprocess_tiers(from_where)
    epoch = _epoch_of(job, epoch)
    pms = (cfg.predict_methods if predict_methods == 'all'
           else list(predict_methods))
    mms = develop_starred_methods(
        cfg.misclass_methods if misclass_methods == 'all'
        else list(misclass_methods))
    if not pms or not mms:
        return {}

    # source: recorder if available, else fresh compute
    sdir = _sample_dir(job, epoch)
    name = (testset.name if testset is not None
            else job.training_parameters.get('set') or 'cifar10')
    rec_path = find_record(sdir, name) if sdir else None
    if rec_path and 'recorders' in from_where:
        rec = LossRecorder.load(rec_path)
    elif 'compute' not in from_where:
        return {}
    else:
        if testset is None:
            _, testset = get_dataset(name, splits=['test'])
        # WIM twin methods are recorder-only (see _is_wim_method)
        fresh = [m for m in mms if not _is_wim_method(m)]
        for m in mms:
            if _is_wim_method(m):
                logging.warning('misclass method %s needs WIM twin '
                                'recordings — skipped', m)
        mms = fresh
        if not mms:
            return {}
        rec = LossRecorder(batch_size)
        graph, generator = held_graph(
            job, 'misclassification',
            lambda g: _score_graph(job, mms, mesh, g), key=mms,
            seed=epoch + 2, generator=generator, mesh=mesh, graphed=graphed)
        _collect_scores(job, testset, mms, batch_size, rec, graph, generator,
                        num_batch, mesh=mesh)
        # persist the fresh recording even when no prior record file
        # existed (find_record only returns pre-existing files)
        if rec_path is None and sdir:
            rec_path = os.path.join(sdir, record_filename(name))
        if rec_path:
            _save_recorder(rec, rec_path)

    losses, logits, y = _recorder_tensors(rec, job.device)

    mms_avail = [m for m in mms
                 if (not m.startswith('odin') or m in rec)
                 and (not _is_wim_method(m)
                      or all(c in rec for c in needed_components(m)))]
    ms = batch_dist_measures(cfg, logits, losses, mms_avail)
    host = _pull_rows(ms)
    results = {}
    for pm in pms:
        try:
            y_ = predict_after_evaluate(cfg, logits, losses, pm).cpu().numpy()
        except KeyError:
            continue
        correct = y_ == y
        missed = ~correct
        if correct.sum() == 0 or missed.sum() == 0:
            continue
        acc = correct.mean()
        results[pm] = {'accuracy': float(acc)}
        correct_t = torch.as_tensor(correct, device=job.device)
        for m in mms_avail:
            v = host[m]
            # honor the -2s / -a-p-q suffix geometry here too (the
            # reference's misclass path omits it, cvae.py:2003, but none of
            # its default misclass methods carry a suffix)
            two_sided = two_sided_from_method(m)
            r = _roc_entry(ms[m][correct_t], ms[m][~correct_t], m)
            thr = np.asarray(r['thresholds'], np.float32)
            if two_sided:
                thr_up = np.asarray(r['thresholds_up'], np.float32)
                pos = ((v[None, :] >= thr[:, None])
                       & (v[None, :] <= thr_up[:, None]))
            else:
                pos = v[None, :] >= thr[:, None]
            tp = (pos & correct[None]).sum(1)
            fp = (pos & missed[None]).sum(1)
            precision = tp / np.maximum(tp + fp, 1)
            recall = tp / max(correct.sum(), 1)
            results[pm][m] = {
                'n': int(len(y)), 'epochs': epoch,
                'sampling': cfg.test_latent_sampling,
                'auc': r['auc'],
                'tpr': [float(t) for t in KEPT_TPR],
                'fpr': r['fpr'],
                'precision': precision.tolist(),
                'recall': recall.tolist(),
            }
        if update_self_results:
            job.testing.setdefault(epoch, {})
            prev = job.testing[epoch].get(pm, {})
            if len(y) < prev.get('n', 0):
                # never let a smaller-sample misclass run degrade a stored
                # higher-confidence accuracy (mirrors accuracy()'s guard)
                continue
            base = {'n': int(len(y)), 'epochs': epoch,
                    'sampling': cfg.test_latent_sampling,
                    'accuracy': float(acc)}
            base.update({k: v for k, v in prev.items()
                         if k not in base})
            for m in mms_avail:
                base[m] = results[pm][m]
            job.testing[epoch][pm] = base
    return results
