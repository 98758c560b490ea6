"""Windowed metric meters (a copy of ``cvpytorch_tpu/utils/meters.py``).

``SmoothedValue`` tracks a deque window (median/avg) plus global totals;
``LossLogger`` aggregates a dict of them per epoch.
"""
from __future__ import annotations

import math
from collections import defaultdict, deque


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        value = float(value)
        self.window.append(value)
        self.total += value * n
        self.count += n

    @property
    def median(self) -> float:
        if not self.window:
            return math.nan
        vals = sorted(self.window)
        mid = len(vals) // 2
        if len(vals) % 2:
            return vals[mid]
        return 0.5 * (vals[mid - 1] + vals[mid])

    @property
    def avg(self) -> float:
        if not self.window:
            return math.nan
        return sum(self.window) / len(self.window)

    @property
    def global_avg(self) -> float:
        if not self.count:
            return math.nan
        return self.total / self.count

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else math.nan

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value,
        )


class LossLogger:
    """Aggregate named losses per epoch."""

    def __init__(self, window_size: int = 20):
        self.meters: dict[str, SmoothedValue] = defaultdict(
            lambda: SmoothedValue(window_size)
        )

    def update(self, losses: dict, n: int = 1):
        for name, val in losses.items():
            self.meters[name].update(float(val), n)

    def reset(self):
        self.meters.clear()

    def get(self, name: str) -> SmoothedValue:
        return self.meters[name]

    def averages(self) -> dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def __str__(self):
        return ", ".join(f"{k}: {m.avg:.4f}" for k, m in self.meters.items())
