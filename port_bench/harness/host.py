"""What the host did over a window, for a look at a run's spread: the
process's own CPU seconds (user and system, every thread of it) and the
seconds spent in Python's garbage collector."""

import gc
import os
import time


class HostMeter:
    def __init__(self):
        self._gc_t = None
        self.gc_s, self.gc_runs = 0.0, 0
        self._start = None

    def _on_gc(self, phase, info):
        if phase == 'start':
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_runs += 1
            self._gc_t = None

    def start(self) -> None:
        t = os.times()
        self._start = (time.perf_counter(), t.user, t.system)
        gc.callbacks.append(self._on_gc)

    def stop(self) -> dict:
        gc.callbacks.remove(self._on_gc)
        t = os.times()
        w0, u0, s0 = self._start
        return {'wall_s': round(time.perf_counter() - w0, 3),
                'user_s': round(t.user - u0, 2),
                'system_s': round(t.system - s0, 2),
                'gc_s': round(self.gc_s, 3), 'gc_runs': self.gc_runs}
