"""Profiling and tracing: a ``torch.profiler`` trace around a block, per-step
host metrics and the card's memory counters.

Port of ``joint_vae_tpu/utils/profiling.py`` (SURVEY.md section 5: the
reference only has wall-clock accounting).  ``trace`` records the host's
operators and, on a CUDA card, its kernels, and writes one Chrome trace
(``trace-<pid>-<time>.json``, for chrome://tracing or Perfetto) into
``log_dir``.
"""

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = 'log/traces', enabled: bool = True):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when a card
    is available), exported as a Chrome trace into ``log_dir``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        try:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            prof.stop()
            path = os.path.join(log_dir, 'trace-{}-{}.json'.format(
                os.getpid(), time.strftime('%Y%m%d-%H%M%S')))
            prof.export_chrome_trace(path)
            logging.info('trace written to %s', path)
        except Exception as e:
            logging.warning('trace stop failed: %s', e)


class StepTimer:
    """Per-step host metrics: images/sec, step latency EMA."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._t = None
        self.latency = float('nan')
        self.count = 0

    def tick(self, batch_size: int = 0) -> Dict[str, float]:
        now = time.perf_counter()
        if self._t is not None:
            dt = now - self._t
            self.latency = (dt if self.latency != self.latency
                            else self.ema * self.latency + (1 - self.ema) * dt)
        self._t = now
        self.count += 1
        ips = batch_size / self.latency if self.latency == self.latency \
            and self.latency > 0 else float('nan')
        return {'step': self.count, 'latency_s': self.latency,
                'images_per_sec': ips}


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """``bytes_in_use`` and ``peak_bytes_in_use`` of a CUDA device (the
    current one by default), from ``torch.cuda.memory_stats``; None for
    the CPU or without a card."""
    if device is not None and torch.device(device).type != 'cuda':
        return None
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {'bytes_in_use': int(stats.get('allocated_bytes.all.current', 0)),
            'peak_bytes_in_use': int(stats.get('allocated_bytes.all.peak', 0))}
