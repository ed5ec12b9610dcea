"""The device mesh on torch.distributed: ranks, sharding rules, placement,
the mesh scope and the collectives of a mesh run.

Port of ``joint_vae_tpu/parallel/mesh.py``.  The mesh changes where
tensors live, not the numbers: on any mesh the port gives what its own
one-process run gives on the same inputs.

- **Ranks.** One process per device (``torchrun --nproc-per-node N``), so
  a mesh of N devices is a world of N ranks.  Rank ``r`` sits at the
  row-major coordinate of ``np.arange(n).reshape(data, model[, sample])``,
  the order in which the JAX package reshapes ``jax.devices()``: rank
  ``r`` holds what JAX's device ``r`` holds.  One process group per axis
  (``init_device_mesh``); a world of one process needs none.
- **'data'** splits the batch: each rank runs its block of rows, the
  gradients are averaged over the 'data' group (``shard_steps.py``), and
  evaluation outputs are gathered back by rows.  A random draw inside a
  mesh scope draws the global batch's noise from the same generator on
  every rank and keeps this rank's rows; BatchNorm in training reduces
  its sums over the group.
- **'model'** splits the class axis: the prior's mean and variance and the
  classifier head's columns and bias live as this rank's block of classes
  (:func:`state_shardings`).  A consumer gathers them where it reads them,
  through a gather whose backward keeps this rank's block (every rank of a
  model group computes the same loss); evaluation computes the per-class
  terms on the block and gathers them along C.
- **'sample'** splits the L+1 latent samples of an evaluation's decode;
  the per-sample losses are gathered before anything consumes them.

The collectives are ``all_reduce``, ``all_gather`` (into one
preallocated tensor), ``broadcast`` and ``barrier``: the ones that gloo
also runs on CUDA tensors.  Those on a step's or an evaluation batch's
path can be captured in a CUDA graph over NCCL (``train/graphs.py``):
each takes its output buffer from the allocator on the capturing stream,
and none reads a card value on the host.
"""

import contextlib
import contextvars
import dataclasses
import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

class Mesh:
    """A mesh over the world's ranks: ``shape`` {axis: size} in axis
    order, this rank's ``coords``, the process group of each axis (None
    in a world without torch.distributed) and their ``backend`` ('nccl',
    'gloo'; None without groups)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None,
                 device: Optional[torch.device] = None,
                 backend: Optional[str] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values())))
        self.rank = int(rank)
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self.groups = dict(groups or {})
        self.device = device
        self.backend = backend if self.groups else None

    @property
    def host_staged(self) -> bool:
        """Whether its collectives pass through host memory: gloo's on a
        card, which a CUDA graph cannot capture."""
        return (self.backend == 'gloo' and self.device is not None
                and self.device.type == 'cuda')

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self):
        return 'Mesh({}, rank={})'.format(self.shape, self.rank)


def mesh_coords(n: int, model_axis: int = 1, sample_axis: int = 1
                ) -> np.ndarray:
    """The rank grid: ``np.arange(n)`` in the mesh's shape."""
    if sample_axis > 1:
        return np.arange(n).reshape(n // (model_axis * sample_axis),
                                    model_axis, sample_axis)
    return np.arange(n).reshape(n // model_axis, model_axis)


def world() -> Tuple[int, int]:
    """(world size, rank): (1, 0) without torch.distributed."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ('data', 'model'),
              model_axis: int = 1, sample_axis: int = 1,
              device=None) -> Mesh:
    """The mesh over the world: ('data', 'model') with the model axis
    sized ``model_axis``, plus a 'sample' axis when ``sample_axis > 1``.
    ``n_devices`` must equal the world size (one rank per device); None
    means the whole world.  ``device`` defaults to this rank's card when
    there is one, else the CPU."""
    size, rank = world()
    n = n_devices or size
    if n != size:
        raise ValueError(
            'a mesh of {} devices needs a world of {} processes, one per '
            'device (torchrun --nproc-per-node {}); this world has {}'
            .format(n, n, n, size))
    if n % (model_axis * sample_axis):
        raise ValueError('{} devices do not divide into model axis {} x '
                         'sample axis {}'.format(n, model_axis, sample_axis))
    names = tuple(axis_names)
    dims = (n // (model_axis * sample_axis), model_axis)
    if sample_axis > 1:
        names, dims = names + ('sample',), dims + (sample_axis,)
    shape = dict(zip(names, dims))
    if device is None:
        device = (torch.device('cuda', torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device('cpu'))
    groups, backend = {}, None
    if size > 1 or (dist.is_available() and dist.is_initialized()):
        from torch.distributed.device_mesh import init_device_mesh
        backend = dist.get_backend()
        kind = 'cuda' if backend == 'nccl' else 'cpu'
        dm = init_device_mesh(kind, dims, mesh_dim_names=names)
        groups = {a: dm.get_group(a) for a in names}
    return Mesh(shape, rank, groups, torch.device(device), backend)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the world of ranks; returns (world size, rank).

    An explicit ``num_processes`` rendezvous at ``coordinator_address``
    ('host:port' or a URL).  Without it the context is read from
    torchrun's environment (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT)
    or SLURM's (SLURM_NTASKS, SLURM_PROCID, and MASTER_ADDR/MASTER_PORT or
    ``coordinator_address``); no context is a one-process no-op.
    ``backend`` defaults to 'nccl' with a card and 'gloo' without: the
    one asked for is the one used.  Each rank takes its local card
    (LOCAL_RANK or SLURM_LOCALID, modulo the cards it sees)."""
    if dist.is_initialized():
        return world()
    env = os.environ
    rank = local = None
    if num_processes is None:
        if int(env.get('WORLD_SIZE', '1') or 1) > 1:
            num_processes = int(env['WORLD_SIZE'])
            rank = int(env['RANK'])
            local = int(env.get('LOCAL_RANK', rank))
            coordinator_address = coordinator_address or 'env://'
        elif int(env.get('SLURM_NTASKS', '1') or 1) > 1:
            num_processes = int(env['SLURM_NTASKS'])
            rank = int(env['SLURM_PROCID'])
            local = int(env.get('SLURM_LOCALID', rank))
            if coordinator_address is None:
                coordinator_address = '{}:{}'.format(
                    env.get('MASTER_ADDR', 'localhost'),
                    env.get('MASTER_PORT', '29500'))
        else:
            return 1, 0
    else:
        rank = int(process_id or 0)
        local = rank
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())
    url = coordinator_address or 'localhost:29500'
    if '://' not in url:
        url = 'tcp://' + url
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes), rank=rank)
    return world()


# ---------------------------------------------------------------------------
# sharding rules and placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A PartitionSpec on a mesh: per leading dim, the axis that splits it
    (or None); dims past the spec are whole."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Split the leading (batch) axis over 'data'."""
    return Sharding(mesh, ('data',) + (None,) * (ndim - 1))


def _prior_spec(path_names: Sequence[str], shape: Sequence[int],
                model_axis: int) -> Tuple[Optional[str], ...]:
    """The rule per parameter leaf, on its JAX path and JAX-layout shape:
    prior leaves split over 'model' on their first axis, the classifier
    head's kernel by columns and its bias; all else replicated."""
    names = list(path_names)
    if 'prior' in names and len(shape) >= 1:
        if shape[0] > 1 and shape[0] % model_axis == 0:
            return ('model',)
    if 'classifier' in names and 'head' in names:
        if names[-1] == 'kernel' and shape[-1] % model_axis == 0:
            return (None, 'model')
        if names[-1] == 'bias' and shape[0] % model_axis == 0:
            return ('model',)
    return ()


def _jax_layout(model) -> Dict[str, Tuple[str, Tuple[int, ...], bool]]:
    """parameter name -> (JAX path, JAX-layout shape, transposed): a Dense
    weight (out, in) is the JAX kernel (in, out)."""
    from ..models.layers import Dense
    from ..save_load.from_jax import param_paths
    dense = {n for n, m in model.named_modules() if isinstance(m, Dense)}
    out = {}
    for name, path in param_paths(model).items():
        p = model.get_parameter(name)
        mod = name.rpartition('.')[0]
        tr = mod in dense and name.endswith('.weight')
        shape = tuple(p.shape)[::-1] if tr else tuple(p.shape)
        out[name] = (path, shape, tr)
    return out


def state_shardings(mesh: Mesh, model) -> Dict[str, Sharding]:
    """The sharding of each parameter of an unsplit model, in the port's
    layout (a Dense weight's spec is its JAX kernel's reversed); the
    optimizer's moments share their parameter's.  Every split leaf is
    split on its dim 0."""
    m = mesh.axis_size('model')
    out = {}
    for name, (path, shape, tr) in _jax_layout(model).items():
        spec = _prior_spec(path.split('/'), shape, m)
        if tr and spec:
            spec = tuple(reversed(spec + (None,) * (2 - len(spec))))
        out[name] = Sharding(mesh, tuple(spec))
    return out


def _block(n: int, parts: int, index: int) -> slice:
    per = n // parts
    return slice(index * per, (index + 1) * per)


def put_global(a, sharding: Sharding) -> torch.Tensor:
    """A host array (the same full copy on every rank) -> this rank's
    block of it on the mesh's device: each split dim is cut by the rank's
    index on its axis; no collective."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    mesh = sharding.mesh
    idx = []
    for dim, axis in enumerate(sharding.spec):
        if axis is None or mesh.axis_size(axis) == 1:
            idx.append(slice(None))
            continue
        if t.shape[dim] % mesh.axis_size(axis):
            raise ValueError('dim {} of size {} does not divide the mesh '
                             "'{}' axis ({})".format(dim, t.shape[dim], axis,
                                                     mesh.axis_size(axis)))
        idx.append(_block(t.shape[dim], mesh.axis_size(axis),
                          mesh.index(axis)))
    out = t[tuple(idx)] if idx else t
    if mesh.device is not None and out.device != mesh.device:
        out = out.to(mesh.device)
    return out.contiguous()


class ClassSplit:
    """This rank's block of a module's class-split tensors (dim 0) and the
    gather that rebuilds them where they are read."""

    def __init__(self, mesh: Mesh, names: Sequence[str]):
        self.mesh = mesh
        self.names = frozenset(names)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_block(t, self.mesh, 'model', 0)


def put_tree(state, shardings: Dict[str, Sharding]):
    """Place a TrainState whose model holds the full (replicated) weights:
    each split parameter and its optimizer moments keep this rank's block,
    and the modules holding them learn to gather them.  In place; returns
    the state."""
    model = state.model
    split = {n: sh for n, sh in shardings.items()
             if any(a is not None and sh.mesh.axis_size(a) > 1
                    for a in sh.spec)}
    mesh = next(iter(shardings.values())).mesh if shardings else None
    with torch.no_grad():
        for name, sh in split.items():
            p = model.get_parameter(name)
            p.data = put_global(p.data, sh)
            for moments in (state.opt_state.mu, state.opt_state.nu,
                            state.opt_state.trace):
                if name in moments:
                    moments[name] = put_global(moments[name], sh)
    by_module: Dict[str, list] = {}
    for name in split:
        mod, _, leaf = name.rpartition('.')
        by_module.setdefault(mod, []).append(leaf)
    for mod, leaves in by_module.items():
        model.get_submodule(mod).split = ClassSplit(mesh, leaves)
    model.mesh = mesh
    return state


def split_names(model) -> set:
    """Names of the model's parameters held as a block over 'model'."""
    out = set()
    for mod_name, mod in model.named_modules():
        sp = getattr(mod, 'split', None)
        if isinstance(sp, ClassSplit):
            out |= {(mod_name + '.' if mod_name else '') + n
                    for n in sp.names}
    return out


def ensure_placed(state, mesh: Mesh):
    """Place a state on the mesh with the sharding rules, unless its model
    is already placed there."""
    if getattr(state.model, 'mesh', None) is mesh:
        return state
    if getattr(state.model, 'mesh', None) is not None:
        raise ValueError('the state is placed on another mesh; reload it '
                         'to place it on this one')
    return put_tree(state, state_shardings(mesh, state.model))


# ---------------------------------------------------------------------------
# the mesh scope: how the batch and the samples are split right now
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scope:
    mesh: Mesh
    rows: bool = True        # the batch axis is this rank's block of rows
    samples: bool = False    # the decode takes this rank's block of samples
    same_noise: bool = False  # draws are local-shaped, equal on every rank


_SCOPE: contextvars.ContextVar = contextvars.ContextVar('jvt_mesh_scope',
                                                        default=None)


@contextlib.contextmanager
def mesh_scope(mesh: Optional[Mesh], rows: bool = True,
               samples: bool = False, same_noise: bool = False):
    """Inside: random draws take this rank's rows of the global batch's
    draw and BatchNorm reduces its training statistics over 'data'
    (``rows``); an evaluation splits its decode over 'sample'
    (``samples``); ``same_noise`` draws the local shape instead, the same
    numbers on every rank.  ``mesh=None`` is a no-op."""
    if mesh is None:
        yield
        return
    tok = _SCOPE.set(Scope(mesh, rows, samples, same_noise))
    try:
        yield
    finally:
        _SCOPE.reset(tok)


def current_scope() -> Optional[Scope]:
    return _SCOPE.get()


def _row_split() -> Optional[Tuple[Mesh, int, int]]:
    sc = _SCOPE.get()
    if sc is None or not sc.rows or sc.mesh.axis_size('data') == 1:
        return None
    return sc.mesh, sc.mesh.axis_size('data'), sc.mesh.index('data')


def draw_rows(draw, shape: Tuple[int, ...]) -> torch.Tensor:
    """``draw(shape)`` as this rank's rows (axis -2) of the global batch's
    draw: every rank of a 'data' group draws the global shape from the
    same generator state and keeps its block, so the noise equals the
    one-process run's."""
    rs = _row_split()
    if rs is None or _SCOPE.get().same_noise:
        return draw(tuple(shape))
    _, d, i = rs
    n = shape[-2]
    full = tuple(shape[:-2]) + (n * d,) + tuple(shape[-1:])
    return draw(full).narrow(-2, i * n, n)


def batch_moments(x: torch.Tensor, axes: Tuple[int, ...]):
    """(mean, biased variance clipped at 0) of ``x`` over ``axes`` and, in
    a row-split scope, over the 'data' group too (the sums all-reduced
    with their gradient)."""
    rs = _row_split()
    if rs is None:
        mean = torch.mean(x, dim=axes)
        return mean, torch.clamp(torch.mean(torch.square(x), dim=axes)
                                 - torch.square(mean), min=0.0)
    mesh, d, _ = rs
    count = float(np.prod([x.shape[a] for a in axes]) * d)
    s = torch.stack([torch.sum(x, dim=axes),
                     torch.sum(torch.square(x), dim=axes)])
    s = all_reduce_sum(s, mesh, 'data') / count
    return s[0], torch.clamp(s[1] - torch.square(s[0]), min=0.0)


def sample_blocks(n: int, parts: int) -> list:
    """Contiguous blocks of ``n`` samples over ``parts`` ranks, the first
    ones a sample longer (17 over 2: 9 + 8)."""
    sizes = [n // parts + (1 if i < n % parts else 0) for i in range(parts)]
    starts = np.cumsum([0] + sizes)
    return [(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]


def sample_split() -> Optional[Tuple[Mesh, int, int]]:
    """(mesh, parts, index) when the scope splits the samples: the
    counterpart of the JAX package's ``sample_constraint``; this rank's
    samples are its block of :func:`sample_blocks`."""
    sc = _SCOPE.get()
    if sc is None or not sc.samples or sc.mesh.axis_size('sample') == 1:
        return None
    return sc.mesh, sc.mesh.axis_size('sample'), sc.mesh.index('sample')


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _group_or_none(mesh: Mesh, axis: str):
    g = mesh.group(axis)
    return g if (g is not None and mesh.axis_size(axis) > 1) else None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over the axis's group, differentiable: the gradient of
    each rank's input is the sum of the gradients of every rank's
    output."""
    g = _group_or_none(mesh, axis)
    if g is None:
        return x
    return _AllReduceSum.apply(x, g)


def all_reduce_mean_(x: torch.Tensor, mesh: Mesh, axis: str,
                     force: bool = False) -> torch.Tensor:
    """In-place mean over the axis's group (no autograd).  ``force`` runs
    the collective on a group of one rank too."""
    g = mesh.group(axis)
    n = mesh.axis_size(axis)
    if g is None or (n == 1 and not force):
        return x
    dist.all_reduce(x, group=g)
    if n > 1:
        x.div_(n)
    return x


# ``all_gather_into_tensor``'s newer name, where PyTorch has it
_all_gather_single = getattr(dist, 'all_gather_single', None) or \
    dist.all_gather_into_tensor


def _all_gather_cat(x: torch.Tensor, group, parts: int, dim: int
                    ) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank
    order, gathered into one tensor (the blocks concatenated along dim
    0)."""
    full = x.new_empty((parts * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(full, x.contiguous(), group=group)
    if dim == 0:
        return full
    return torch.cat(full.view((parts,) + tuple(x.shape)).unbind(0), dim=dim)


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, parts, index, dim):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        return _all_gather_cat(x, group, parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None,
                None, None)


def gather_block(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0
                 ) -> torch.Tensor:
    """Equal blocks along ``dim`` gathered over the axis's group, in rank
    order.  Differentiable for a value every rank of the group consumes
    the same way: the backward keeps this rank's block of the gradient
    (not the sum over the group that ``all_gather``'s own backward
    gives, which would be ``parts`` times the true gradient)."""
    g = _group_or_none(mesh, axis)
    if g is None:
        return x
    return _GatherBlock.apply(x, g, mesh.axis_size(axis), mesh.index(axis),
                              dim)


def gather_uneven(x: torch.Tensor, mesh: Mesh, axis: str,
                  sizes: Sequence[int], dim: int = 0) -> torch.Tensor:
    """Blocks of the given sizes along ``dim`` gathered over the axis's
    group (each padded to the largest, then trimmed); no gradient."""
    g = _group_or_none(mesh, axis)
    if g is None:
        return x
    top = max(sizes)
    pad = top - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    full = _all_gather_cat(x, g, len(sizes), dim)
    parts = [full.narrow(dim, i * top, s) for i, s in enumerate(sizes)]
    return torch.cat(parts, dim=dim)


def gather_rows_dict(tensors: Dict[str, torch.Tensor], dims: Dict[str, int],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Several evaluation outputs, each with its rows on ``dims[k]``,
    gathered over 'data' in one flattened ``all_gather``."""
    g = _group_or_none(mesh, 'data')
    if g is None or not tensors:
        return dict(tensors)
    names = list(tensors)
    moved = [torch.movedim(tensors[k], dims[k], 0) for k in names]
    n = moved[0].shape[0]
    flat = torch.cat([t.float().reshape(n, -1) for t in moved], dim=1)
    full = _all_gather_cat(flat, g, mesh.axis_size('data'), 0)
    out, at = {}, 0
    for k, t in zip(names, moved):
        w = t[0].numel() if n else int(np.prod(t.shape[1:]))
        part = full[:, at:at + w].reshape((-1,) + tuple(t.shape[1:]))
        out[k] = torch.movedim(part.to(t.dtype), 0, dims[k])
        at += w
    return out


def host_get(tree, sharding: Optional[Sharding] = None):
    """Tensors -> host numpy arrays; with a ``sharding``, each split dim
    is gathered over its axis first (a collective: every rank must call
    this on the same tree)."""
    def pull(x):
        if not isinstance(x, torch.Tensor):
            return x
        if sharding is not None:
            for dim, axis in enumerate(sharding.spec):
                if axis is not None:
                    x = gather_block(x, sharding.mesh, axis, dim)
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_get(v, sharding) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_get(v, sharding) for v in tree)
    return pull(tree)


def broadcast_object(obj, mesh: Optional[Mesh] = None, src: int = 0):
    """Rank ``src``'s picklable object on every rank (a no-op alone)."""
    size, _ = world()
    if size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier():
    size, _ = world()
    if size > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# evaluation feeding
# ---------------------------------------------------------------------------

def warn_replicated_fallback(flag: dict, batch: int, nd: int):
    """One warning for a batch size that does not divide the mesh 'data'
    axis (every batch then runs whole on every rank).  ``flag`` is the
    caller's warn state, shared across putters so that one evaluation
    warns at most once."""
    if not flag.get('warned'):
        flag['warned'] = True
        logging.warning(
            'eval batch size %d does not divide the mesh data axis '
            '(%d): batches run fully replicated (exact but each '
            'device computes the whole batch) — pick a batch size '
            "divisible by mesh.shape['data']", batch, nd)


def eval_batch_putters(mesh: Mesh, ndim: int,
                       warn_flag: Optional[dict] = None):
    """(put_x, put_y) for feeding evaluation batches over 'data': a batch
    that divides the axis goes in as this rank's rows, one that does not
    (a tail) goes in whole to every rank, which stays exact.  A first
    batch that takes the whole path warns once (every batch will).  Use
    :func:`rows_split` to tell which path a batch took."""
    sh_x = batch_sharding(mesh, ndim)
    sh_y = batch_sharding(mesh, 1)
    rep = replicated(mesh)
    nd = mesh.axis_size('data')
    flag = warn_flag if warn_flag is not None else {}

    def putter(sh, is_x):
        def put(a):
            host = np.asarray(a)
            if host.shape[0] % nd == 0:
                flag.setdefault('full_seen', True)
                return put_global(host, sh)
            # only a full-size first batch signals the every-batch cliff;
            # a tail after full batches is the expected exact fallback
            if is_x and not flag.get('full_seen'):
                warn_replicated_fallback(flag, host.shape[0], nd)
            return put_global(host, rep)
        return put

    return putter(sh_x, True), putter(sh_y, False)


def rows_split(mesh: Optional[Mesh], n: int) -> bool:
    """Whether a batch of ``n`` rows runs split over 'data'."""
    return (mesh is not None and mesh.axis_size('data') > 1
            and n % mesh.axis_size('data') == 0)


def eval_feed(mesh: Optional[Mesh], device: torch.device, ndim: int):
    """(put, run) for an evaluation loop: ``put(x)`` sends a host batch
    to the device (this rank's rows when it divides the 'data' axis, else
    whole); ``run(n, fn, row_dim)`` calls ``fn()`` in the batch's mesh
    scope (the samples split over 'sample') and gathers the rows of the
    dict of tensors it returns (``row_dim(key, tensor)`` gives each one's
    row axis) when the batch of ``n`` rows was split.  Without a mesh:
    ``to_device`` and a plain call."""
    if mesh is None:
        from ..device import to_device
        return (lambda a: to_device(a, device)), (lambda n, fn, row_dim: fn())
    put_x, _ = eval_batch_putters(mesh, ndim, {})

    def run(n, fn, row_dim):
        split = rows_split(mesh, n)
        with mesh_scope(mesh, rows=split, samples=True):
            out = fn()
        if not split:
            return out
        return gather_rows_dict(out, {k: row_dim(k, v)
                                      for k, v in out.items()}, mesh)
    return put_x, run
