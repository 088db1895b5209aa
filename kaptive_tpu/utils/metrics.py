r"""Process-global pipeline counters (fallbacks, kernel impl choices, DP shapes).

Round-2 shipped a regressed benchmark with no way to tell which code path had
actually run (silent host fallbacks, unbounded DP bucket-shape growth).  This module is the antidote: cheap named counters and
value-sets that the hot paths bump unconditionally (a dict update — no flag
gating needed) and ``bench.py`` / ``--profile`` print next to the phase table.

Conventions used by the pipeline:

- ``map.host_fallback.{row_overflow,candidates,anchors,chains}``
                                           — genomes reseeded on host, by cause
- ``map.device_chained`` / ``map.host_chained`` — genomes chained on device vs host
- ``swg.dispatch.{cuda,lax}``              — DP bucket launches per kernel impl
- ``swg.offlattice``                       — pairs that fell outside a frozen shape lattice
- ``swg.shape.<rows>x<w>x<b>``             — distinct compiled DP bucket shapes (set)
"""

from __future__ import annotations

import sys
import threading
from collections import defaultdict

_COUNTS: dict[str, int] = defaultdict(int)
_SHAPES: set[str] = set()
# Counters are bumped from several threads (the ingest pool, the streaming
# pipeline's device stage, the main thread) and the bench reads them as
# evidence of which code path ran — guard the read-modify-writes.
_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    r"""Increment counter ``name`` by ``n`` (thread-safe)."""
    with _LOCK:
        _COUNTS[name] += n


def record_shape(kind: str, *dims: int) -> bool:
    r"""Record a compiled-shape key; returns True the first time it is seen.

    A True return means the upcoming dispatch will trigger a fresh XLA
    compile (unless the persistent cache already holds it) — callers count it
    so the bench output shows steady-state compile churn.
    """
    key = f"{kind}:" + "x".join(str(d) for d in dims)
    with _LOCK:
        if key in _SHAPES:
            return False
        _SHAPES.add(key)
        _COUNTS[f"{kind}.new_shape"] += 1
    return True


def snapshot() -> dict[str, int]:
    return dict(_COUNTS)


def shapes() -> tuple[str, ...]:
    return tuple(sorted(_SHAPES))


def reset_metrics(keep_shapes: bool = False) -> None:
    r"""Clear counters; with ``keep_shapes`` the compiled-shape set survives,
    so a later ``*.new_shape`` count means a genuinely fresh compile (bench
    resets counters after warm-up but keeps the warm shape set)."""
    _COUNTS.clear()
    if not keep_shapes:
        _SHAPES.clear()


def metrics_report(stream=None) -> dict[str, int]:
    r"""Print accumulated counters (and the compiled-shape set) to stderr."""
    stream = stream or sys.stderr
    if _COUNTS:
        width = max(len(k) for k in _COUNTS)
        print("#  pipeline counters:", file=stream)
        for name in sorted(_COUNTS):
            print(f"   {name:<{width}}  {_COUNTS[name]}", file=stream)
    if _SHAPES:
        print(f"#  compiled DP shapes: {', '.join(sorted(_SHAPES))}", file=stream)
    return dict(_COUNTS)
