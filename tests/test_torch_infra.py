"""The port's device and profiling utilities (``utils/device.py``,
``utils/profiling.py``) against the JAX package's, on the CPU:

- ``compute_max_batch_size``: the same result and the same sequence of
  probed sizes as the JAX function's on the same fake step, the port's
  step raising ``torch.OutOfMemoryError`` where the JAX one raises its
  RESOURCE_EXHAUSTED error (doubling, halving below ``start``, nothing
  fits), other errors propagated, the per-key cache; after each
  out-of-memory the failed step's tensors are released before the cache
  is freed;
- ``dump_crash``: ``batch.npz`` reads back, ``error.txt``, the job loads
  in both packages;
- ``StepTimer`` against the JAX package's on a patched clock;
- ``trace`` writes a Chrome trace naming the traced operators on the CPU,
  and nothing when disabled; ``device_memory_stats`` is None off a card.
"""

import gc
import os
import time
import weakref

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from joint_vae_tpu.save_load.jobs import load_job as jload_job
from joint_vae_tpu.utils import device as jdevice
from joint_vae_tpu.utils import profiling as jprofiling

from joint_vae_tpu_torch.save_load.jobs import load_job, new_job
from joint_vae_tpu_torch.utils import device as tdevice
from joint_vae_tpu_torch.utils import profiling as tprofiling

from torch_port_util import port_cfg


def _probe(mod, fits, start, ceiling, error):
    calls = []

    def step(n):
        calls.append(n)
        if not fits(n):
            raise error()
    return mod.compute_max_batch_size(step, start=start,
                                      ceiling=ceiling), calls


@pytest.mark.parametrize('fits,start,ceiling', [
    (lambda n: n <= 512, 128, 4096),          # doubling up to 512
    (lambda n: n <= 48, 128, 4096),           # start too big: halving to 32
    (lambda n: True, 128, 1024),              # the ceiling
    (lambda n: False, 8, 64),                 # nothing fits: 0
], ids=['double', 'halve', 'ceiling', 'none'])
def test_probe_matches_jax(fits, start, ceiling):
    want = _probe(jdevice, fits, start, ceiling,
                  lambda: RuntimeError('RESOURCE_EXHAUSTED: out of memory'))
    got = _probe(tdevice, fits, start, ceiling,
                 lambda: torch.OutOfMemoryError('CUDA out of memory.'))
    assert got == want


@pytest.mark.parametrize('message', [
    'CUDA error: out of memory', 'CUBLAS_STATUS_ALLOC_FAILED when calling '
    'cublasCreate(handle)', 'cuDNN error: CUDNN_STATUS_ALLOC_FAILED'])
def test_probe_cuda_messages_and_other_errors(message):
    got = _probe(tdevice, lambda n: n <= 256, 128, 4096,
                 lambda: RuntimeError(message))
    assert got == (256, [128, 256, 512])
    with pytest.raises(ValueError, match='bad shape'):
        _probe(tdevice, lambda n: n <= 256, 128, 4096,
               lambda: ValueError('bad shape'))


def test_probe_cache_by_key():
    calls = []

    def step(n):
        calls.append(n)
        if n > 64:
            raise torch.OutOfMemoryError('out of memory')
    key = ('test_probe_cache_by_key',)
    assert tdevice.compute_max_batch_size(step, 16, 1024, key=key) == 64
    assert tdevice.compute_max_batch_size(step, 16, 1024, key=key) == 64
    assert calls == [16, 32, 64, 128]


def test_probe_frees_the_failed_step_before_the_cache(monkeypatch):
    refs, seen = [], []

    def step(n):
        t = torch.empty(n)
        refs.append(weakref.ref(t))
        if n > 32:
            raise torch.OutOfMemoryError('out of memory')

    def free():
        gc.collect()
        seen.append([r() is None for r in refs])
    monkeypatch.setattr(tdevice, '_free_cache', free)
    assert tdevice.compute_max_batch_size(step, 16, 1024) == 32
    assert seen == [[True, True, True]]


def test_dump_crash(tmp_path):
    jcfg = graft._flagship_cfg(tiny=True)
    job = new_job(port_cfg(jcfg), seed=3, job_number=9, device='cpu')
    x = torch.rand(2, 3, 8, 8)
    y = torch.tensor([1, 3])
    for mod, d in ((tdevice, 'port'), (jdevice, 'jax')):
        if mod is jdevice:
            x, y = x.numpy(), y.numpy()
        out = mod.dump_crash(job if mod is tdevice else None, x, y,
                             ValueError('boom'), log_dir=str(tmp_path / d))
        with np.load(os.path.join(out, 'batch.npz')) as z:
            np.testing.assert_array_equal(z['x'], np.asarray(x))
            np.testing.assert_array_equal(z['y'], np.asarray(y))
        with open(os.path.join(out, 'error.txt')) as f:
            assert f.read() == "ValueError('boom')"
    out = str(tmp_path / 'port' / 'dump-9')
    back = load_job(out, device='cpu')
    sd, sd2 = job.model.state_dict(), back.model.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    assert jload_job(out).job_number == 9
    # no label: an empty y, as the JAX function writes
    out = tdevice.dump_crash(job, x, None, ValueError('boom'),
                             log_dir=str(tmp_path / 'nolabel'))
    with np.load(os.path.join(out, 'batch.npz')) as z:
        assert z['y'].shape == (0,)


def test_step_timer_matches_jax(monkeypatch):
    ticks = iter([0.0, 0.5, 0.75, 1.5, 1.5, 1.5, 2.0, 2.1, 2.2, 2.3])
    clock = {'t': 0.0}
    monkeypatch.setattr(time, 'perf_counter', lambda: clock['t'])
    tj, tt = jprofiling.StepTimer(), tprofiling.StepTimer(ema=0.9)
    for t in ticks:
        clock['t'] = t
        want, got = tj.tick(32), tt.tick(32)
        assert got.keys() == want.keys()
        for k in want:
            assert (np.isnan(got[k]) and np.isnan(want[k])) or \
                got[k] == want[k], (t, k)


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / 'traces')
    with tprofiling.trace(d):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith('.json')
    with open(os.path.join(d, files[0])) as f:
        text = f.read()
    assert '"traceEvents"' in text and 'aten::mm' in text
    with tprofiling.trace(str(tmp_path / 'off'), enabled=False):
        torch.mm(torch.ones(2, 2), torch.ones(2, 2))
    assert not os.path.exists(tmp_path / 'off')
    with jprofiling.trace(enabled=False):        # the JAX package's noop
        pass


def test_device_memory_stats_off_a_card():
    assert tprofiling.device_memory_stats('cpu') is None
    if not torch.cuda.is_available():
        assert tprofiling.device_memory_stats() is None
