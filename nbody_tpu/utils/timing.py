"""Timing / throughput instrumentation.

The reference has **no timers at all** (SURVEY.md section 6 — not even
ms/step); this module is the rebuild's first-class replacement: wall-clock
step timing and the GInteractions/s metric (interactions/step = N^2, as
defined by the all-pairs sweep, kernel.cu:99-114).

JAX dispatches asynchronously, so every timed region ends in ``sync()``,
which waits for the device with ``jax.block_until_ready``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import jax


def sync(*arrays) -> None:
    """Completion barrier: wait until every array (or pytree) is ready."""
    jax.block_until_ready(arrays)


@dataclass
class StepTimer:
    """Accumulates per-chunk wall times for steps/sec + GInter/s reporting."""
    n_bodies: int
    times_s: List[float] = field(default_factory=list)
    steps_per_chunk: List[int] = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int):
        self.times_s.append(time.perf_counter() - self._t0)
        self.steps_per_chunk.append(n_steps)

    @property
    def total_steps(self) -> int:
        return sum(self.steps_per_chunk)

    @property
    def total_time_s(self) -> float:
        return sum(self.times_s)

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * self.total_time_s / max(1, self.total_steps)

    @property
    def steps_per_s(self) -> float:
        return self.total_steps / self.total_time_s if self.total_time_s else 0.0

    @property
    def ginter_per_s(self) -> float:
        inter = float(self.n_bodies) ** 2 * self.total_steps
        return inter / self.total_time_s / 1e9 if self.total_time_s else 0.0


def measure_steps(fn, state, n_steps: int, warmup: bool = True):
    """Time fn(state, n_steps) -> state with proper completion barriers.
    Returns (final_state, seconds)."""
    if warmup:
        out = fn(state, n_steps)
        sync(out)
    t0 = time.perf_counter()
    out = fn(state, n_steps)
    sync(out)
    return out, time.perf_counter() - t0
