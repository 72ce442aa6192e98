"""Timing scopes and step-rate accounting (analog of src/time.cpp
time_sink/timing_scope, meep.hpp:1610-1653, and
python/timing_measurements.py).

On the device the per-phase breakdown inside a compiled scan is not observable from
the host; the meaningful metrics are wall time per run block, steps/sec, and
cell-updates/sec, plus jax.profiler traces for on-device breakdowns."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

# the reference's time-sink categories (meep.hpp:1610)
CATEGORIES = [
    "stepping", "connecting", "boundaries", "fields_io", "dft",
    "mode_solve", "near2far", "setup", "other",
]


class Timers:
    """Accumulated wall time per category (fields::time_spent_on analog)."""

    def __init__(self):
        self.acc: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, category: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[category] += time.perf_counter() - t0
            self.counts[category] += 1

    def time_spent_on(self, category: str) -> float:
        return self.acc.get(category, 0.0)

    def summary(self) -> Dict[str, float]:
        return dict(self.acc)

    def print_times(self):
        for k, v in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            print(f"{k:>14s}: {v:9.3f} s  ({self.counts[k]} calls)")


def profiler_trace(logdir: str):
    """jax.profiler trace context for on-device phase breakdowns (the
    device-side analog of the reference's per-kernel timing_scope)."""
    import jax
    return jax.profiler.trace(logdir)
