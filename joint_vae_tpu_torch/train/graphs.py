"""CUDA graphs of the port's one-program steps and scoring batches: the
counterpart of ``jax.jit``.

The JAX package runs each hot program as one compiled program that the
host dispatches once: the train step (``joint_vae_tpu/train/steps.py:80``,
``jax.jit(step, donate_argnums=(0,))``), the device-fed step and the fused
whole-epoch program (``train/device_data.py:150-191``), the WIM fine-tune
step (``ft/job.py:314-316``), and the scoring programs: the Scorer's
``jax.jit run`` (``serve.py:58``), the engines' ``eval_batch`` /
``eval_scan`` (``evals/engines.py:148-161``) and the fine-tune flow's
both-prior ``eval_batch`` (``ft/job.py:101-105``).  On the card the
counterpart is a CUDA graph: the body captured once per input shapes,
replayed by one host call per step or batch.

:class:`GraphRunner` is what both kinds share.  It owns the static input
buffers (one set per input shapes: the loaders drop a
train set's last batch, so a run has one; a scored set's ragged tail has
its own), and on the card:

- runs the first call of each buffer set eagerly on a side stream as a
  real step or batch (it moves the parameters, the moments, sigma and the
  generator; nothing is restored), so that every library handle, plan
  and kernel library is made before the capture;
- then captures the body on a capture stream in the default
  ``capture_error_mode``, with the run's generator registered
  (``register_generator_state``: each replay draws the numbers the eager
  body would), and replays it from then on.  A capture that fails
  raises; nothing falls back to eager runs.

Every runner warms up on one side stream per card, so that the
warm-ups of every runner reuse the same cached memory, and captures on
one capture stream per card, which runs nothing else; the caller's
stream joins it after a capture.  On PyTorch 2.11 a graph's replay drew
the numbers of its generator at offset 0, now and then, when an eager
draw from that generator (another entry's warm-up) had run on the
stream the graph was captured on, or when the graph was captured on
another stream than the last eager draw's: 0-9 of 40 runs as the
engines' held graphs run a set, each of 40 with the card synchronised
around the warm-ups, none with the capture stream apart
(``scripts/torch_graph_race_probe.py``).  The
entries of one runner share one private memory pool: they never replay
at the same time, so a ragged tail's graph reuses the full batch's
intermediates, and a graph's outputs are taken (copied or pulled to
the host) before the runner replays again.  (A pool is not shared
between runners: PyTorch 2.11 cannot capture into a pool again once
every graph of it is gone.)  A capture neither synchronises nor
empties the allocator's cache, as ``torch.cuda.graph`` does: the card
runs the batches queued while the host captures.  The cache is given
back first only when it holds more idle memory than the card has free.

A new owner (a step's generator, optimizer and sigma state, or what
its caller names instead; a scoring batch's generator and whatever else
its caller names) means new captures: the ones held and their pool are
dropped, and the owners are held, so that no other object takes their
place.  :func:`held_graph` holds a program's scoring graph and its
generator on a job across calls, reseeded per call or per batch.

The kernel wrappers count their launches where they call their kernels:
in eager runs, in the warm-up and in the capture, never in a replay,
which calls no wrapper.  What a replay launches is read from the graph
instead: at capture the graph's kernel nodes are counted by their
functions' names, per kernel source of ``ops/cuda_lib.py``, and must
equal the launches the wrappers counted while capturing, or the capture
raises.  ``captures`` records each capture's seconds, launches, kernel
nodes, NCCL's kernel nodes and the nodes by type, the bytes it added to
the pool and whether the cache was given back first; :data:`steps_run`
counts the step graphs' steps and :data:`batches_run` the scoring
graphs' batches by graph name, each by how they ran.

A :class:`StepGraph` holds a step body ``body(state, **inputs) -> {name:
0-dim tensor}`` that updates the state's tensors in place and reads every
value that moves between steps (learning rate, Adam's count, the warmup
ramps, the prior-mean thaw) from 0-dim device tensors, so that a replay
computes what the eager body computes; it packs the metrics into one
float32 vector (its output).  Its state is a train state by default
(its generator, optimizer and sigma state the owners), or any object
with a ``generator`` (None: no noise) and the owners its caller names.
A :class:`ScoreGraph` holds a scoring body ``body(generator, **inputs)
-> {name: tensor}`` (losses, logits, scores) that changes no state but
the generator's; its outputs are static tensors that the next replay
overwrites, so the caller takes copies or pulls them to the host first.

The backward of a captured step accumulates each parameter's gradient on
the stream its gradient accumulator was made on.  An autograd graph
through the parameters built eagerly on the default stream and still
alive at the capture (an eager forward's output kept) holds accumulators
on that stream, and the capture then fails; drop it first.

On a mesh (``parallel/mesh.py``) a step's or batch's collectives go
into its graph when the mesh's groups are NCCL's (:func:`graph_mode`),
as ``jax.jit`` compiles a sharded program's collectives into it.  What
PyTorch 2.11 and NCCL 2.28 need, found on the card
(``scripts/torch_nccl_graph_probe.py``):

- a group's communicator is made by its first collective, which a
  capture cannot hold (the capture is invalidated): the entry's eager
  warm-up runs every collective of the body once before its capture;
- ProcessGroupNCCL runs a captured collective on its own stream, joined
  to the capture by events, and keeps it out of its watchdog's queue;
  ``capture_begin`` waits until the watchdog has retired the eager ones,
  so the default 'global' ``capture_error_mode`` holds, even right
  after an eager collective;
- a collective in a backward (``mesh.py::_AllReduceSum``) is issued from
  autograd's device thread on the capturing stream, and is captured;
- a collective reads no value on the host, and its output buffer comes
  from the allocator on the capturing stream (the all-gather fills one
  preallocated tensor);
- an all-reduce in place on a group of one rank is no work for NCCL: the
  graph holds no node of it (the one-rank mesh's), where two ranks give
  NCCL's kernels (counted by name in ``captures``).

The mesh scope that the caller entered (``mesh.py::mesh_scope``: a batch
split over 'data' or whole, its samples split or not) decides the body's
collectives, so each entry is keyed by it as well as by the inputs'
shapes: a ragged tail run whole never replays a split batch's graph,
though this rank's rows of the split batch may have the tail's shape.
gloo stages each collective through host memory, which a capture cannot
hold: a mesh over gloo on a card runs eagerly.

On the CPU, which only a caller's explicit ``device='cpu'`` reaches, the
same body runs eagerly on the same static buffers, on a mesh too.
``graphed=False`` runs the body eagerly on the inputs as given (the
eager reference that ``chip_smoke.py`` holds a graph against).
"""

import ctypes
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from ..ops import cuda_lib
from ..parallel.mesh import current_scope


_HOW = ('eager', 'captured', 'replayed')
# every runner's warm-up stream and its capture stream, by card (module
# docstring)
_side_streams: Dict[torch.device, Any] = {}
_capture_streams: Dict[torch.device, Any] = {}
# every step graph's steps since :func:`reset_steps_run`, by how they ran:
# 'eager' (the body called: an eager step, a warm-up, a step on the CPU),
# 'captured' (the body recorded into a graph; that step then runs as a
# replay) and 'replayed'.  The wrappers count the launches of the eager and
# captured ones.
steps_run = dict.fromkeys(_HOW, 0)
# the same for the scoring graphs' batches, by graph name
batches_run: Dict[str, Dict[str, int]] = {}


def graph_mode(graphed: Optional[bool], mesh) -> bool:
    """Whether a step or scoring batch runs as a graph: by default, off a
    mesh and on a mesh whose collectives a graph can hold (NCCL's, a mesh
    without groups, any on the CPU, where the body runs on the static
    buffers).  gloo on a card stages each collective through host memory,
    which a capture cannot hold: such a mesh runs eagerly, and asking it
    for a graph raises."""
    if mesh is not None and mesh.host_staged:
        if graphed:
            raise ValueError(
                'a mesh over gloo on a card runs eagerly (gloo stages its '
                'collectives through host memory, which a CUDA graph '
                'cannot capture): graphed=True cannot be asked of it')
        return False
    return True if graphed is None else bool(graphed)


def reset_steps_run() -> None:
    """:data:`steps_run` and :data:`batches_run` to 0."""
    for k in steps_run:
        steps_run[k] = 0
    batches_run.clear()


@dataclasses.dataclass
class Rows:
    """Rows ``rows`` (an index tensor, or a slice) of ``src``: a batch that
    a step gathers straight into its static buffer."""
    src: torch.Tensor
    rows: Union[torch.Tensor, slice]

    @property
    def shape(self) -> tuple:
        if isinstance(self.rows, slice):
            n = len(range(*self.rows.indices(self.src.shape[0])))
        else:
            n = self.rows.shape[0]
        return (n,) + tuple(self.src.shape[1:])

    def into(self, out: torch.Tensor) -> None:
        if isinstance(self.rows, slice):
            out.copy_(self.src[self.rows])
        else:
            torch.index_select(self.src, 0, self.rows, out=out)

    def value(self) -> torch.Tensor:
        if isinstance(self.rows, slice):
            return self.src[self.rows]
        return torch.index_select(self.src, 0, self.rows)


class PackedMetrics(dict):
    """name -> 0-dim view of ``vector``, the step's packed metrics (a copy
    of a graph's output, which the next replay overwrites)."""

    def __init__(self, names: List[str], vector: torch.Tensor):
        super().__init__(zip(names, vector.unbind(0)))
        self.vector = vector


@dataclasses.dataclass
class _Entry:
    buffers: Dict[str, torch.Tensor]
    warm: bool = False               # its eager warm-up has run
    graph: Optional[torch.cuda.CUDAGraph] = None
    out: Any = None


def _outputs(out) -> List[torch.Tensor]:
    return [out] if isinstance(out, torch.Tensor) else list(out.values())


class GraphRunner:
    """The static buffers, warm-up, capture, replay and run counts that a
    step graph and a scoring graph share (module docstring)."""

    def __init__(self, body: Callable, *, name: str, graphed: bool = True):
        # an object's own method is held weakly: the object owns this
        # graph, and the graph's memory goes with the object
        self._body = (weakref.WeakMethod(body) if hasattr(body, '__self__')
                      else lambda: body)
        self.name = name
        self.graphed = graphed
        self.captures: List[dict] = []
        self._entries: Dict[tuple, _Entry] = {}
        self._owner: tuple = ()
        self._pool = None               # the entries' graph pool

    def _count(self, how: str) -> None:
        steps_run[how] += 1

    def _entry(self, owner: tuple, given: dict) -> _Entry:
        """The buffers for ``given``'s shapes, dtypes and devices in the
        caller's mesh scope, filled from ``given``.  A new ``owner`` drops
        the entries held."""
        if (len(owner) != len(self._owner)
                or any(a is not b for a, b in zip(owner, self._owner))):
            self._entries.clear()
            self._pool = None
            self._owner = owner
        inputs = tuple(
            (k, tuple(v.shape), v.src.dtype if isinstance(v, Rows)
             else v.dtype, (v.src if isinstance(v, Rows) else v).device)
            for k, v in sorted(given.items()))
        # the scope decides the body's collectives (module docstring)
        key = (current_scope(), inputs)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(buffers={
                k: torch.empty(shape, dtype=dt, device=dev)
                for k, shape, dt, dev in inputs})
        for k, v in given.items():
            if isinstance(v, Rows):
                v.into(entry.buffers[k])
            else:
                entry.buffers[k].copy_(v)
        return entry

    def _run(self, entry: _Entry, generator: Optional[torch.Generator],
             fn: Callable):
        """``fn(buffers)``: on the CPU; on the card as the entry's warm-up,
        else captured once and replayed.  Returns its outputs (a replay's
        are the graph's static ones)."""
        dev = next(iter(entry.buffers.values())).device
        if dev.type != 'cuda':
            self._count('eager')
            return fn(entry.buffers)
        side = _side_streams.get(dev)
        if side is None:
            side = _side_streams[dev] = torch.cuda.Stream(dev)
        if not entry.warm:
            entry.warm = True
            self._count('eager')
            cur = torch.cuda.current_stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = fn(entry.buffers)
            cur.wait_stream(side)
            for t in _outputs(out):
                t.record_stream(cur)
            return out
        if entry.graph is None:
            stream = _capture_streams.get(dev)
            if stream is None:
                stream = _capture_streams[dev] = torch.cuda.Stream(dev)
            cur = torch.cuda.current_stream(dev)
            stream.wait_stream(cur)
            self._capture(entry, generator, dev, stream, fn)
            cur.wait_stream(stream)
        entry.graph.replay()
        self._count('replayed')
        return entry.out

    def _capture(self, entry: _Entry, generator: Optional[torch.Generator],
                 dev: torch.device, stream, fn: Callable) -> None:
        # kept, to count its kernel nodes before it is instantiated
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            graph.register_generator_state(generator)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        idle = (torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
        emptied = torch.cuda.mem_get_info(dev)[0] < idle
        if emptied:
            torch.cuda.empty_cache()
        grown = _malloced(dev)
        before = cuda_lib.launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self._pool)
            try:
                entry.out = fn(entry.buffers)
            finally:
                graph.capture_end()
        nodes = kernel_nodes(graph.raw_cuda_graph())
        graph.instantiate()
        capture_s = time.perf_counter() - t0
        after = cuda_lib.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        if nodes is not None and nodes['by_source'] != cuda_lib.by_source(
                launches):
            raise RuntimeError(
                '{}: the graph holds {} kernel nodes of the port\'s kernels, '
                'its capture launched {}'.format(self.name, nodes['by_source'],
                                                 launches))
        self._count('captured')
        entry.graph = graph
        self.captures.append({
            'name': self.name,
            'inputs': {k: list(v.shape) for k, v in entry.buffers.items()},
            'capture_s': capture_s,
            'launches': {k: v for k, v in launches.items() if v},
            'kernel_nodes': None if nodes is None else nodes['total'],
            'kernel_nodes_by_source': None if nodes is None
            else nodes['by_source'],
            'nccl_kernel_nodes': None if nodes is None else nodes['nccl'],
            'nodes_by_type': None if nodes is None else nodes['by_type'],
            'pool_bytes': _malloced(dev) - grown,
            'emptied_cache': emptied})


def _malloced(dev: torch.device) -> int:
    """The bytes the allocator has taken from the card so far (a private
    pool's growth: it never takes the cache's blocks)."""
    return torch.cuda.memory_stats(dev)['reserved_bytes.all.allocated']


class StepGraph(GraphRunner):
    """One step body, captured per input shapes and replayed (module
    docstring).  Each step adds its packed metrics into :attr:`sums`
    inside the step (the fused epoch's carry)."""

    def __init__(self, body: Callable, *, name: str, graphed: bool = True):
        super().__init__(body, name=name, graphed=graphed)
        self.names: Optional[List[str]] = None
        self.sums: Optional[torch.Tensor] = None

    # ---- the body, packed ----------------------------------------------
    def _packed(self, state, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        m = self._body()(state, **inputs)
        names = list(m)
        if self.names is None:
            self.names = names
        elif names != self.names:
            raise RuntimeError('{}: the step\'s metrics changed from {} to '
                               '{}'.format(self.name, self.names, names))
        vec = torch.stack([v.detach().float().reshape(()) for v in m.values()])
        if self.sums is None:
            self.sums = torch.zeros_like(vec)
        self.sums.add_(vec)
        return vec

    def reset_sums(self) -> None:
        """Zero :attr:`sums` (before an epoch)."""
        if self.sums is not None:
            self.sums.zero_()

    def metrics(self, vector: torch.Tensor) -> PackedMetrics:
        return PackedMetrics(self.names, vector)

    # ---- one real step ---------------------------------------------------
    def __call__(self, state, *, owner: Optional[tuple] = None,
                 **inputs) -> PackedMetrics:
        """One real step on ``inputs`` (tensors, :class:`Rows`, or None for
        an input not given); returns its metrics, a copy of the graph's
        output on the card.  ``owner``: what the body reads that can be
        rebound (default: a train state's optimizer and sigma state);
        ``state.generator`` always is one."""
        given = {k: v for k, v in inputs.items() if v is not None}
        if not self.graphed:
            self._count('eager')
            return self.metrics(self._packed(state, {
                k: v.value() if isinstance(v, Rows) else v
                for k, v in given.items()}))
        if owner is None:
            owner = (state.opt_state, state.sigma_state.data,
                     state.sigma_state.rmse)
        # a new generator or owner means new captures
        entry = self._entry((state.generator,) + tuple(owner), given)
        out = self._run(entry, state.generator,
                        lambda bufs: self._packed(state, bufs))
        return self.metrics(out.clone() if entry.graph is not None else out)


class ScoreGraph(GraphRunner):
    """One scoring body ``body(generator, **inputs) -> {name: tensor}``,
    captured per input shapes and replayed (module
    docstring); its batches count in :data:`batches_run` under its
    name."""

    def _count(self, how: str) -> None:
        runs = batches_run.setdefault(self.name, dict.fromkeys(_HOW, 0))
        runs[how] += 1

    def __call__(self, generator: Optional[torch.Generator], *,
                 owner: tuple = (), **inputs) -> Dict[str, torch.Tensor]:
        """One batch on ``inputs`` (tensors, or None for an input not
        given; the buffers live on each input's device), its noise drawn
        from ``generator``.  ``owner``: objects besides the generator
        whose change means new captures.  Returns the body's outputs,
        after a capture copies of the graph's static ones."""
        given = {k: v for k, v in inputs.items() if v is not None}
        body = self._body()
        if not self.graphed:
            self._count('eager')
            return body(generator, **given)
        entry = self._entry((generator,) + tuple(owner), given)
        out = self._run(entry, generator,
                        lambda bufs: body(generator, **bufs))
        if entry.graph is not None:
            out = {k: v.clone() for k, v in out.items()}
        return out


def held_graph(job, kind: str, make: Callable[[bool], ScoreGraph], *,
               key: tuple = (), seed: int = 0,
               generator: Optional[torch.Generator] = None, mesh=None,
               graphed: Optional[bool] = None):
    """The scoring graph of program ``kind`` on ``job`` (``make(graphed)``
    builds it, its body on ``mesh``) and the generator of its batches.
    Graphed (the default, :func:`graph_mode`), both are held on the job
    across calls, one graph per kind (another ``key``, mesh, device,
    model or sigma state replaces it), and the generator is reseeded with
    ``seed`` (as a fresh generator of that seed draws); a caller's
    ``generator`` means new captures.  Otherwise an eager graph and a
    fresh generator."""
    dev = job.device
    if not graph_mode(graphed, mesh):
        return make(False), (generator if generator is not None else
                             torch.Generator(device=dev).manual_seed(
                                 int(seed)))
    held = vars(job).setdefault('_score_graphs', {})
    key = (tuple(key), mesh, dev)
    reads = (job.model, job.sigma_state.data, job.sigma_state.rmse)
    h = held.get(kind)
    if h is None or h[0] != key or any(a is not b
                                      for a, b in zip(h[1], reads)):
        h = held[kind] = (key, reads, make(True),
                          torch.Generator(device=dev))
    graph, gen = h[2], h[3]
    return graph, (generator if generator is not None
                   else gen.manual_seed(int(seed)))


def held_score_graphs(job) -> Dict[str, ScoreGraph]:
    """The scoring graphs held on ``job``, by program."""
    return {k: v[2] for k, v in vars(job).get('_score_graphs', {}).items()}


class _KernelNodeParams(ctypes.Structure):
    """libcuda's ``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [('func', ctypes.c_void_p), ('grid', ctypes.c_uint * 3),
                ('block', ctypes.c_uint * 3), ('shared_bytes', ctypes.c_uint),
                ('params', ctypes.c_void_p), ('extra', ctypes.c_void_p),
                ('kern', ctypes.c_void_p), ('ctx', ctypes.c_void_p)]


# libcuda's CUgraphNodeType, by value
_NODE_TYPES = ('kernel', 'memcpy', 'memset', 'host', 'graph', 'empty',
               'wait_event', 'event_record', 'semaphore_signal',
               'semaphore_wait', 'mem_alloc', 'mem_free', 'batch_mem_op',
               'conditional')


def kernel_nodes(raw_graph: int) -> Optional[dict]:
    """The nodes of a ``cudaGraph_t``: ``{'total': kernel nodes,
    'by_source': {source: n}, 'nccl': n, 'by_type': {type: n}}``, the
    kernel nodes of each kernel source of ``ops/cuda_lib.py`` and NCCL's
    (a name holding 'nccl') told apart by their functions' names (libcuda's
    ``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams``, ``cuFuncGetName``); None where libcuda
    cannot be loaded.  A call that fails raises."""
    try:
        cu = ctypes.CDLL('libcuda.so.1')
    except OSError:
        return None

    def check(rc: int, what: str) -> None:
        if rc:
            raise RuntimeError('{} returned CUresult {}'.format(what, rc))
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), 'cuGraphGetNodes')
    nodes = (ctypes.c_void_p * n.value)()
    if n.value:                 # an empty graph: no array to fill
        check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
              'cuGraphGetNodes')
    kind = ctypes.c_int(0)
    params = _KernelNodeParams()
    name = ctypes.c_char_p()
    total, nccl, by_type = 0, 0, {}
    by_source = dict.fromkeys(cuda_lib.KERNEL_FUNCTIONS, 0)
    for node in nodes:
        node = ctypes.c_void_p(node)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
              'cuGraphNodeGetType')
        t = (_NODE_TYPES[kind.value] if kind.value < len(_NODE_TYPES)
             else str(kind.value))
        by_type[t] = by_type.get(t, 0) + 1
        if kind.value != 0:                       # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        total += 1
        check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
              'cuGraphKernelNodeGetParams')
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(params.func)),
                  'cuFuncGetName')
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(params.kern)),
                  'cuKernelGetName')
        fn = name.value.decode()
        source = cuda_lib.source_of(fn)
        if source is not None:
            by_source[source] += 1
        nccl += 'nccl' in fn.lower()
    return {'total': total, 'by_source': by_source, 'nccl': nccl,
            'by_type': by_type}
