r"""Multi-host execution scaffolding: process init, input sharding, shard writers.

BASELINE config 5 ("1000+ assemblies across four H100 cards") needs
three host-side pieces on top of the device sharding in
:mod:`kaptive_tpu.parallel.typing`:

1. :func:`initialize_distributed` — idempotent ``jax.distributed.initialize``
   from explicit args or the standard env (``JAX_COORDINATOR_ADDRESS``,
   ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``, ``JAX_LOCAL_DEVICE_IDS``).
   After it, ``jax.devices()`` spans every process's cards and the mesh
   builders in :mod:`kaptive_tpu.parallel.mesh` lay collectives over them.
2. :func:`shard_inputs` — deterministic round-robin assignment of input files
   to processes, so every host streams a disjoint subset (no coordination
   needed beyond the rank).
3. :class:`ShardedJsonlWriter` — per-host JSONL shard files
   (``<stem>.part-NNNNN.jsonl``) with *stream resume*: on reopen it scans the
   existing shard and skips genomes already written, making 1000+-assembly
   runs idempotent per assembly (the reference's JSONL round-trip gives the
   same property per file — ``/root/reference/docs/serotyping/outputs.md``).

The logic is pure host code and unit-tested on a single process
(``tests/test_multihost.py``); a real multi-process run only adds the
coordinator env.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import IO, Any

_DISTRIBUTED_READY = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> bool:
    r"""Initialise JAX multi-process mode once; returns True when distributed.

    Falls back to single-process when no coordinator is configured (arg or
    ``JAX_COORDINATOR_ADDRESS`` env) — so the same entry path serves laptops,
    one card, and several hosts.  ``local_device_ids`` (or the
    comma-separated ``JAX_LOCAL_DEVICE_IDS`` env) gives this process its own
    cards, so several processes on one host each own one card instead of all
    reserving every card's memory.
    """
    global _DISTRIBUTED_READY
    if _DISTRIBUTED_READY:
        return True
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator_address:
        return False
    if local_device_ids is None and os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        local_device_ids = [int(x) for x in os.environ["JAX_LOCAL_DEVICE_IDS"].split(",")]
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
        process_id=process_id if process_id is not None else int(os.environ.get("JAX_PROCESS_ID", "0")),
        local_device_ids=local_device_ids,
    )
    _DISTRIBUTED_READY = True
    return True


def process_rank_and_count() -> tuple[int, int]:
    r"""(process_index, process_count) — (0, 1) when not distributed."""
    try:
        import jax

        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def shard_inputs(
    inputs: list, rank: int | None = None, world: int | None = None
) -> list:
    r"""Deterministic round-robin slice of the input list for this process.

    Round-robin (not contiguous blocks) keeps per-host work balanced when
    input files are sorted by size or name.
    """
    if rank is None or world is None:
        rank, world = process_rank_and_count()
    if world <= 1:
        return list(inputs)
    return [x for i, x in enumerate(inputs) if i % world == rank]


def shard_path(path: str | Path, rank: int | None = None, world: int | None = None) -> Path:
    r"""Per-process output shard path: ``x.jsonl`` -> ``x.part-00003.jsonl``.

    Single-process runs keep the plain path.
    """
    if rank is None or world is None:
        rank, world = process_rank_and_count()
    path = Path(path)
    if world <= 1:
        return path
    return path.with_name(f"{path.stem}.part-{rank:05d}{path.suffix}")


class ShardedJsonlWriter:
    r"""Append-mode JSONL shard writer with per-assembly stream resume.

    ``written`` holds the genome ids already present in the shard (loaded at
    open); :meth:`should_skip` lets the caller avoid re-typing them entirely.
    """

    def __init__(self, path: str | Path, rank: int | None = None, world: int | None = None):
        self.path = shard_path(path, rank, world)
        self.written: set[str] = set()
        if self.path.exists():
            with self.path.open("rb") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self.written.add(json.loads(line)["genome"])
                    except (ValueError, KeyError):
                        continue  # torn tail line from an interrupted run
        self._handle: IO[bytes] = self.path.open("ab")
        # A crash can leave a torn final line; terminate it so appended
        # records stay line-delimited (the torn record is re-typed).  Check
        # only the last byte — re-reading a multi-hundred-MB shard here would
        # double the resume cost.
        if self.path.stat().st_size:
            with self.path.open("rb") as fh:
                fh.seek(-1, 2)
                if fh.read(1) != b"\n":
                    self._handle.write(b"\n")

    def should_skip(self, genome_id: str) -> bool:
        return genome_id in self.written

    def write_result(self, result: Any) -> None:
        from kaptive_tpu.serotyping.cli import result_to_jsonl_bytes

        if result.genome in self.written:
            return
        self._handle.write(result_to_jsonl_bytes(result))
        self._handle.flush()  # per-line durability is the resume contract
        self.written.add(result.genome)

    def close(self) -> None:
        self._handle.close()

    def __enter__(self) -> "ShardedJsonlWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
