"""Step timing without a per-step device sync (a copy of
``cvpytorch_tpu/utils/timer.py``): host wall clock over N steps queued
asynchronously; the caller synchronises only where it reads a value."""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = None
        self.elapsed = 0.0
        self.count = 0

    def tic(self):
        self._start = time.perf_counter()

    def toc(self, n: int = 1) -> float:
        dt = time.perf_counter() - self._start
        self.elapsed += dt
        self.count += n
        return dt

    def ips(self, batch_size: int = 1) -> float:
        """images/sec over all recorded steps."""
        if self.elapsed == 0:
            return 0.0
        return self.count * batch_size / self.elapsed
