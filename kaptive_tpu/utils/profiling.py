r"""Per-phase timers and device trace capture.

The reference has no profiling at all — observability is a verbose flag and a
``\r`` progress counter (``/root/reference/src/kaptive/cli.py:315-346``).  For
an accelerator pipeline that is not enough: it is a chain of device
dispatches and host glue, and knowing which phase dominates decides where the
next kernel goes.  This module adds

- :func:`phase_timer` — a nestable context manager accumulating wall time per
  named phase (enabled with ``$KAPTIVE_PROFILE=1`` or ``--profile``; zero
  overhead otherwise: a single dict lookup);
- :func:`phase_report` — one stderr line per phase (count, total, mean);
- :func:`device_trace` — wraps ``jax.profiler.trace`` so a full XLA/GPU trace
  (viewable in TensorBoard/XProf) can be captured around any region with
  ``$KAPTIVE_TRACE_DIR=/path``.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

_PHASES: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]


def phases_enabled() -> bool:
    return os.environ.get("KAPTIVE_PROFILE", "") == "1"


def reset_phases() -> None:
    _PHASES.clear()


@contextmanager
def phase_timer(name: str):
    r"""Accumulate wall time under ``name`` when profiling is enabled."""
    if not phases_enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        entry = _PHASES[name]
        entry[0] += 1
        entry[1] += time.perf_counter() - t0


def phase_report(stream=None) -> dict[str, tuple[int, float]]:
    r"""Print accumulated phase timings to stderr; returns {name: (count, total_s)}."""
    stream = stream or sys.stderr
    out = {}
    if _PHASES:
        width = max(len(k) for k in _PHASES)
        print("⏱  phase timings:", file=stream)
        for name, (count, total) in sorted(_PHASES.items(), key=lambda kv: -kv[1][1]):
            mean = total / max(count, 1)
            print(
                f"   {name:<{width}}  n={count:<6d} total={total:8.3f}s  mean={mean * 1e3:9.3f}ms",
                file=stream,
            )
            out[name] = (count, total)
    return out


@contextmanager
def device_trace(trace_dir: str | None = None):
    r"""Capture a jax.profiler trace when a directory is configured."""
    trace_dir = trace_dir or os.environ.get("KAPTIVE_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
