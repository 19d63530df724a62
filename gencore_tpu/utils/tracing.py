"""Per-stage timing + optional JAX profiler traces.

The reference has no tracing at all (SURVEY.md §5 — only a wall-clock total,
main.cpp:114-116). This engine times each pipeline stage and can capture
an XLA profile:

  * `StageTimer` accumulates wall-time per named stage; the CLI prints the
    table under --debug;
  * set GENCORE_TRACE_DIR to capture a jax.profiler trace of the run
    (viewable in TensorBoard / xprof).
"""

from __future__ import annotations

import contextlib
import os
import time


class StageTimer:
    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report_lines(self) -> list:
        # totals without a count are pseudo-stages (wire.*MB), not seconds
        timed = {k: v for k, v in self.totals.items() if k in self.counts}
        total = sum(timed.values())
        lines = [f"stage timings (total {total:.3f}s):"]
        for name, t in sorted(timed.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"  {name:<22} {t:8.3f}s {pct:5.1f}%  x{self.counts[name]}")
        return lines


@contextlib.contextmanager
def maybe_jax_trace():
    """Capture a jax profiler trace when GENCORE_TRACE_DIR is set."""
    trace_dir = os.environ.get("GENCORE_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield
