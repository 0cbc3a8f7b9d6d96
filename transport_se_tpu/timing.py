"""Named-region timers: the GPTL analog.

Equivalent of the reference timing infrastructure (reference:
utils/timing/gptl.c, perf_mod.F90 `t_startf/t_stopf/t_prf`): nested named
regions with call counts and wall totals, printable as a HommeTime-style
table.  Device work is asynchronous under JAX, so regions that must measure
device time should call `jax.block_until_ready` on their outputs or use
`timers.time(..., sync=x)`.  For kernel-level profiles use
`jax.profiler.trace` (the device trace is the perf ground truth).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import jax


@dataclasses.dataclass
class _Region:
    count: int = 0
    total: float = 0.0
    max: float = 0.0


class Timers:
    def __init__(self):
        self._regions = defaultdict(_Region)
        self._stack = []

    @contextlib.contextmanager
    def time(self, name: str, sync=None):
        t0 = time.perf_counter()
        self._stack.append(name)
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            dt = time.perf_counter() - t0
            self._stack.pop()
            r = self._regions[name]
            r.count += 1
            r.total += dt
            r.max = max(r.max, dt)

    def reset(self):
        self._regions.clear()

    def report(self) -> str:
        """HommeTime_stats-style summary (perf_mod.F90 `t_prf` analog)."""
        lines = [f"{'name':<36} {'calls':>8} {'walltotal':>12} {'wallmax':>10}"]
        for name, r in sorted(self._regions.items(),
                              key=lambda kv: -kv[1].total):
            lines.append(f"{name:<36} {r.count:>8d} {r.total:>12.3f} "
                         f"{r.max:>10.4f}")
        return "\n".join(lines)

    def get(self, name: str) -> _Region:
        return self._regions[name]


timers = Timers()
