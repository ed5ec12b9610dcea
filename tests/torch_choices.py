"""Record the discrete choices of a PyTorch forward and impose them on
another run of it, for the tests and ``chip_smoke.py``'s training gates.

A gradient follows the branches its forward took: the sign of each ReLU's
input, the argmax of each max-pool window, the side of each clamp bound.
Two devices, or one device at inputs a rounding apart, can take different
branches where an input lies within rounding of the tie, and training-mode
BatchNorm spreads such a flip to every sample's gradient.  Recording one
run's choices and imposing them on the other leaves the two gradients
apart only by rounding.

    choices = Choices()
    with torch.no_grad(), choices.recording():
        forward(...)                    # e.g. on the card
    with choices.imposing() as replay:  # e.g. on the CPU, with autograd
        loss = forward(...)
        grads = torch.autograd.grad(loss, params)
    replay.summary()   # the elements where the imposed choice differs from
                       # this run's own, and their distance to the tie

The choices, each recorded in call order (the ops that a train step, a
fine-tune step and ``evaluate`` call on the flagship, the ResNet trunks
and vgg16, listed by :class:`OpLister`):

- ``relu`` (``torch.relu``, ``F.relu``, ``Tensor.relu``) and
  ``leaky_relu``: the mask ``x > 0``; imposed as ``where(mask, x, 0)`` and
  ``where(mask, x, slope * x)``, whose gradients are the ops' own with the
  imposed mask;
- ``max_pool2d``: the flat argmax of each window (``return_indices``);
  imposed as a gather of the input at those indices (its gradient scatters
  to them, as the pool's does);
- ``clamp`` / ``clip`` of a floating tensor (the encoder's log-variance
  clip, BatchNorm's variance clip at 0, the sigma floor, the prior's
  distance clip): below, inside or above; imposed as the bound or the
  input, the gradient passing inside only, as clamp's does.  A clamp of an
  integer tensor (the sub-pixel deconv's tap indices) is geometry, the same
  on every device, and not recorded;
- ``amax`` / ``amin`` over a whole tensor (the prior's minimal class
  distance): the flat index of the extreme; imposed as the element there.

Not recorded: ``argmax`` of the train step's accuracy metric (detached, no
gradient or loss reads it) and the dropout masks (drawn from a generator,
not chosen by the data).

Replay raises on any difference in the number, order, kind or shape of the
choices, and never falls back to the op's own choice.  It compares each
imposed choice with the one this run makes itself and reports every
element where they differ, with its distance to the tie relative to the
rms of the op's input: ``|x|`` for a ReLU, ``x - bound`` for a clamp, the
gap between this run's window maximum and the imposed element for a pool.

:class:`Float64` runs the port's float32 code in float64 (every float32
cast and dtype argument taken as float64), for a float64 reference run.

Imports torch only.
"""

import contextlib
import dataclasses
import os
import sys
from collections import Counter
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_RELU = {torch.relu, F.relu, torch.Tensor.relu}
_LEAKY = {F.leaky_relu}
_POOL = {F.max_pool2d, torch.max_pool2d}
_CLAMP = {torch.clamp, torch.clip, torch.Tensor.clamp, torch.Tensor.clip}
_EXTREME = {torch.amax: 'amax', torch.amin: 'amin',
            torch.Tensor.amax: 'amax', torch.Tensor.amin: 'amin'}
MAX_FLIPS = 1000          # flipped elements a replay lists (all are counted)
_HERE = os.path.abspath(__file__)
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def _kind(func) -> Optional[str]:
    if func in _RELU:
        return 'relu'
    if func in _LEAKY:
        return 'leaky_relu'
    if func in _POOL:
        return 'max_pool2d'
    if func in _CLAMP:
        return 'clamp'
    return _EXTREME.get(func)


def _site() -> str:
    """file:line of the innermost caller outside this module and torch."""
    f = sys._getframe(2)
    while f is not None:
        name = os.path.abspath(f.f_code.co_filename)
        if name != _HERE and not name.startswith(_TORCH_DIR):
            parts = name.split(os.sep)
            return '{}:{}'.format(os.sep.join(parts[-3:]), f.f_lineno)
        f = f.f_back
    return '?'


def _rms(x: torch.Tensor) -> float:
    x = x.detach().double()
    x = x[torch.isfinite(x)]
    return x.square().mean().sqrt().item() if x.numel() else 0.0


# ---------------------------------------------------------------------------
# Each kind: the op's choice on an input, the op applied with a given
# choice, and the distance of an element's input to the tie.

def _pool_args(args, kwargs):
    """(x, kernel_size, stride, padding, dilation, ceil_mode,
    return_indices) of a max_pool2d call."""
    names = ('input', 'kernel_size', 'stride', 'padding', 'dilation',
             'ceil_mode', 'return_indices')
    vals = dict(zip(names, args))
    vals.update(kwargs)
    vals.setdefault('stride', None)
    vals.setdefault('padding', 0)
    vals.setdefault('dilation', 1)
    vals.setdefault('ceil_mode', False)
    vals.setdefault('return_indices', False)
    return vals


def _clamp_bounds(args, kwargs):
    x = args[0]
    lo = args[1] if len(args) > 1 else kwargs.get('min')
    hi = args[2] if len(args) > 2 else kwargs.get('max')
    return x, lo, hi


def _extreme_args(args, kwargs):
    dim = args[1] if len(args) > 1 else kwargs.get('dim', ())
    keepdim = args[2] if len(args) > 2 else kwargs.get('keepdim', False)
    return args[0], dim, keepdim


def _choose(kind, func, args, kwargs):
    """(the op's output, its choice) on this run's input."""
    if kind in ('relu', 'leaky_relu'):
        return func(*args, **kwargs), args[0] > 0
    if kind == 'max_pool2d':
        a = _pool_args(args, kwargs)
        out, idx = F.max_pool2d(a['input'], a['kernel_size'], a['stride'],
                                a['padding'], a['dilation'], a['ceil_mode'],
                                return_indices=True)
        return (out, idx) if a['return_indices'] else out, idx
    if kind == 'clamp':
        x, lo, hi = _clamp_bounds(args, kwargs)
        side = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
        if lo is not None:
            side = torch.where(x < lo, -1, side).to(torch.int8)
        if hi is not None:
            side = torch.where(x > hi, 1, side).to(torch.int8)
        return func(*args, **kwargs), side
    x, dim, keepdim = _extreme_args(args, kwargs)
    pick = torch.argmax if kind == 'amax' else torch.argmin
    return func(*args, **kwargs), pick(x.detach().reshape(-1))


def _impose(kind, args, kwargs, choice, like):
    """The op's output on this run's input with ``choice`` imposed, laid
    out as ``like`` (the op's own output: the next op's gradient sums in
    that layout)."""
    x = args[0]
    if kind == 'relu':
        out = torch.where(choice, x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    elif kind == 'leaky_relu':
        slope = args[1] if len(args) > 1 else kwargs.get('negative_slope',
                                                          0.01)
        out = torch.where(choice, x, x * slope)
    elif kind == 'max_pool2d':
        flat = x.flatten(-2)
        out = flat.gather(-1, choice.flatten(-2)).reshape(choice.shape)
    elif kind == 'clamp':
        x, lo, hi = _clamp_bounds(args, kwargs)
        out = x
        if lo is not None:
            out = torch.where(choice < 0, torch.as_tensor(
                lo, dtype=x.dtype, device=x.device), out)
        if hi is not None:
            out = torch.where(choice > 0, torch.as_tensor(
                hi, dtype=x.dtype, device=x.device), out)
    else:
        x, dim, keepdim = _extreme_args(args, kwargs)
        out = x.reshape(-1)[choice]
        out = out.reshape((1,) * x.ndim) if keepdim else out
    if isinstance(like, tuple):
        like = like[0]
    if out.stride() != like.stride():
        out = torch.empty_like(like).copy_(out)
    if kind == 'max_pool2d' and _pool_args(args, kwargs)['return_indices']:
        return out, choice
    return out


def _choice_shape_ok(kind, args, kwargs, choice) -> bool:
    """Whether a recorded choice fits this call's input."""
    x = args[0]
    if kind in ('relu', 'leaky_relu', 'clamp'):
        return tuple(choice.shape) == tuple(x.shape)
    if kind == 'max_pool2d':
        return (tuple(choice.shape[:-2]) == tuple(x.shape[:-2])
                and int(choice.max()) < x.shape[-2] * x.shape[-1]
                if choice.numel() else True)
    return choice.ndim == 0 and int(choice) < x.numel()


def _distance(kind, args, kwargs, own, imposed, where):
    """|input - tie| at the flipped elements ``where`` (a bool mask over
    the choice), in units of the rms of the op's input."""
    x = args[0].detach()
    if kind in ('relu', 'leaky_relu'):
        gap = x[where].double().abs()
    elif kind == 'max_pool2d':
        flat = x.flatten(-2).double()
        gap = (flat.gather(-1, own.flatten(-2)).reshape(own.shape)
               - flat.gather(-1, imposed.flatten(-2))
               .reshape(own.shape))[where]
    elif kind == 'clamp':
        _, lo, hi = _clamp_bounds(args, kwargs)
        xs = x.double()
        gaps = [(xs - torch.as_tensor(b, dtype=torch.float64,
                                      device=x.device)).abs()
                .expand(xs.shape) for b in (lo, hi) if b is not None]
        gap = torch.stack(gaps).amin(0)[where]
    else:
        flat = x.reshape(-1).double()
        gap = (flat[own] - flat[imposed]).abs().reshape(1)
    rms = _rms(x)
    return gap / rms if rms > 0 else gap


@dataclasses.dataclass
class Choice:
    kind: str
    site: str
    data: torch.Tensor         # the mask, the pool's indices, the clamp's
                               # side, or the extreme's flat index


@dataclasses.dataclass
class Flip:
    """One element where the imposed choice differs from this run's own."""
    op: int                    # the choice's position in call order
    kind: str
    site: str
    element: tuple             # index into the choice's tensor
    distance: float            # |input - tie| / rms(op's input)


class ChoiceMismatch(AssertionError):
    pass


class _Recorder(TorchFunctionMode):
    def __init__(self, into: List[Choice]):
        super().__init__()
        self.into = into

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _kind(func)
        if kind is None or not _recordable(kind, args, kwargs):
            return func(*args, **kwargs)
        out, choice = _choose(kind, func, args, kwargs)
        self.into.append(Choice(kind, _site(), choice.detach()))
        return out


def _recordable(kind, args, kwargs) -> bool:
    x = args[0] if args else kwargs.get('input')
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return False
    if kind in ('amax', 'amin'):
        _, dim, _ = _extreme_args(args, kwargs)
        if dim not in ((), [], None):
            raise NotImplementedError('{} over dim {}: only whole-tensor '
                                      'reductions are recorded'.format(
                                          kind, dim))
    return True


class Replay(TorchFunctionMode):
    """Imposes a recorded sequence of choices (:meth:`Choices.imposing`);
    ``flips`` lists every element where this run's own choice differs."""

    def __init__(self, choices: List[Choice]):
        super().__init__()
        self.choices = choices
        self.pos = 0
        self.flips: List[Flip] = []
        self.n_flips = 0
        self.worst = 0.0
        self.by_kind = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _kind(func)
        if kind is None or not _recordable(kind, args, kwargs):
            return func(*args, **kwargs)
        site = _site()
        if self.pos >= len(self.choices):
            raise ChoiceMismatch('choice {} ({} at {}) beyond the {} '
                                 'recorded'.format(self.pos, kind, site,
                                                   len(self.choices)))
        rec = self.choices[self.pos]
        if rec.kind != kind:
            raise ChoiceMismatch('choice {}: {} at {}, recorded {} at {}'
                                 .format(self.pos, kind, site, rec.kind,
                                         rec.site))
        x = args[0]
        imposed = rec.data.to(x.device)
        if not _choice_shape_ok(kind, args, kwargs, imposed):
            raise ChoiceMismatch('choice {} ({} at {}): recorded shape {} '
                                 'does not fit input {}'.format(
                                     self.pos, kind, site,
                                     tuple(imposed.shape), tuple(x.shape)))
        with torch.no_grad():
            like, own = _choose(kind, func, tuple(a.detach() if isinstance(
                a, torch.Tensor) else a for a in args), kwargs)
            if tuple(own.shape) != tuple(imposed.shape):
                raise ChoiceMismatch('choice {} ({} at {}): recorded shape {}'
                                     ', this run {}'.format(
                                         self.pos, kind, site,
                                         tuple(imposed.shape),
                                         tuple(own.shape)))
            differ = own != imposed
            n = int(differ.sum())
            if n:
                dist = _distance(kind, args, kwargs, own, imposed, differ)
                self.n_flips += n
                self.by_kind[kind] += n
                self.worst = max(self.worst, dist.max().item())
                idx = differ.nonzero().tolist() if differ.ndim else [[]]
                for e, d in zip(idx, dist.tolist()):
                    if len(self.flips) < MAX_FLIPS:
                        self.flips.append(Flip(self.pos, kind, site,
                                               tuple(e), d))
        self.pos += 1
        return _impose(kind, args, kwargs, imposed, like)

    def summary(self) -> dict:
        """Counts for a report: choices imposed, elements flipped (by kind)
        and the worst distance to the tie; the first flips by op."""
        return {'choices': self.pos, 'flips': self.n_flips,
                'flips_by_kind': dict(self.by_kind),
                'worst_distance': self.worst,
                'first_flips': [dataclasses.asdict(f)
                                for f in self.flips[:8]]}


class Choices:
    """One forward's choices in call order (see the module docstring)."""

    def __init__(self):
        self.items: List[Choice] = []

    def __len__(self) -> int:
        return len(self.items)

    @contextlib.contextmanager
    def recording(self):
        """Record the choices of every op in the block (appended)."""
        with _Recorder(self.items):
            yield self

    @contextlib.contextmanager
    def imposing(self):
        """Impose the recorded choices, in order, on the block; raises
        unless the block makes exactly as many."""
        replay = Replay(self.items)
        with replay:
            yield replay
        if replay.pos != len(self.items):
            raise ChoiceMismatch('{} choices imposed of the {} recorded'
                                 .format(replay.pos, len(self.items)))

    def counts(self) -> dict:
        """Choices by kind and their elements."""
        c = Counter(ch.kind for ch in self.items)
        return {'ops': dict(c),
                'elements': int(sum(ch.data.numel() for ch in self.items))}


def moved_ulp(x: np.ndarray, seed: int = 3) -> np.ndarray:
    """``x`` moved by one float32 ulp, up or down at random per element."""
    toward = np.where(np.random.default_rng(seed).random(x.shape) < 0.5,
                      -np.inf, np.inf).astype(np.float32)
    return np.nextafter(x.astype(np.float32), toward)


class OpLister(TorchFunctionMode):
    """Counts every torch function a block calls, by name (to find the
    piecewise ops on a path)."""

    def __init__(self):
        super().__init__()
        self.seen = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.seen[getattr(func, '__name__', None) or str(func)] += 1
        return func(*args, **(kwargs or {}))


class Float64(TorchFunctionMode):
    """Runs float32 code in float64: ``Tensor.float()``, a float32 dtype
    argument and a float32 tensor argument become float64 (the model's
    parameters are made float64 by the caller).  Raises where an op still
    returns a float32 tensor."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.Tensor.float:
            func, args = torch.Tensor.double, args[:1]
        args = tuple(_f64(a) for a in args)
        kwargs = {k: _f64(v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                raise AssertionError('{} returned float32 under Float64'
                                     .format(getattr(func, '__name__', func)))
        return out


def _f64(a):
    if a is torch.float32:
        return torch.float64
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
        return a.double()
    if isinstance(a, (tuple, list)) and any(
            isinstance(t, torch.Tensor) for t in a):
        return type(a)(_f64(t) for t in a)
    return a
