"""File-sentinel array scheduler (ref ft/scheduler.py:7-57); a copy of
``joint_vae_tpu/ft/scheduler.py``.

Task i of a job array writes ``grid/<seed>.<i>`` and blocks until every
predecessor's sentinel has vanished — serializing array tasks that share a
grid without a real queue."""

import logging
import os
import time
from typing import Optional


class Scheduler:
    def __init__(self, grid_dir: str = 'grid', seed: int = 0,
                 task: int = 0, poll: float = 1.0):
        self.grid_dir = grid_dir
        self.seed = seed
        self.task = task
        self.poll = poll
        os.makedirs(grid_dir, exist_ok=True)

    def _sentinel(self, task: int) -> str:
        return os.path.join(self.grid_dir, '{}.{}'.format(self.seed, task))

    def register(self):
        with open(self._sentinel(self.task), 'w') as f:
            f.write(str(os.getpid()))

    def wait_for_turn(self, timeout: Optional[float] = None):
        """Block until all predecessors' sentinels are gone."""
        t0 = time.time()
        while True:
            preds = [t for t in range(self.task)
                     if os.path.exists(self._sentinel(t))]
            if not preds:
                return True
            if timeout is not None and time.time() - t0 > timeout:
                logging.warning('scheduler timeout waiting for %s', preds)
                return False
            time.sleep(self.poll)

    def done(self):
        try:
            os.unlink(self._sentinel(self.task))
        except FileNotFoundError:
            pass

    def __enter__(self):
        self.register()
        self.wait_for_turn()
        return self

    def __exit__(self, *a):
        self.done()
