"""Step metrics: per-step wall time and throughput, with a sliding window.

Counterpart of ``easydl_tpu/core/metrics.py`` without its telemetry gauges
and its protobuf export (not ported yet).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional


@dataclass
class StepRecord:
    step: int
    loss: float
    step_time_s: float
    samples_per_sec: float
    world_size: int
    timestamp: float = field(default_factory=time.time)
    extras: Dict[str, float] = field(default_factory=dict)

    @property
    def samples_per_sec_per_chip(self) -> float:
        return self.samples_per_sec / max(self.world_size, 1)


class MetricsRecorder:
    """Records steps and maintains a sliding window.

    The first ``warmup`` steps are excluded from window statistics.
    """

    def __init__(self, global_batch: int, world_size: int, window: int = 50, warmup: int = 1):
        self.global_batch = global_batch
        self.world_size = world_size
        self.warmup = warmup
        self._window: Deque[StepRecord] = collections.deque(maxlen=window)
        self._count = 0
        self._last_t: Optional[float] = None

    def start_step(self) -> None:
        self._last_t = time.perf_counter()

    def end_step(self, step: int, loss: float, **extras: float) -> StepRecord:
        now = time.perf_counter()
        dt = (now - self._last_t) if self._last_t is not None else 0.0
        self._last_t = now
        rec = StepRecord(
            step=step,
            loss=loss,
            step_time_s=dt,
            samples_per_sec=self.global_batch / dt if dt > 0 else 0.0,
            world_size=self.world_size,
            extras=extras,
        )
        self._count += 1
        if self._count > self.warmup:
            self._window.append(rec)
        return rec

    def mean_step_time(self) -> float:
        if not self._window:
            return 0.0
        return sum(r.step_time_s for r in self._window) / len(self._window)

    def mean_samples_per_sec(self) -> float:
        if not self._window:
            return 0.0
        return sum(r.samples_per_sec for r in self._window) / len(self._window)

    def mean_samples_per_sec_per_chip(self) -> float:
        return self.mean_samples_per_sec() / max(self.world_size, 1)

    def summary(self) -> Dict[str, float]:
        return {
            "steps": float(self._count),
            "mean_step_time_s": self.mean_step_time(),
            "samples_per_sec": self.mean_samples_per_sec(),
            "samples_per_sec_per_chip": self.mean_samples_per_sec_per_chip(),
        }
