r"""Streaming batch typing: host ingest overlapped with device compute.

The reference loops genomes serially (``serotyping/cli.py:206-208``).  Here a
background thread pool parses/encodes the *next* batch of assemblies (FASTA
parse via the native hostio library when built, 2-bit encoding, packing) while
the device types the current batch — so CPU-side ingest never starves the device
(SURVEY.md §7.4 item 6).  Multi-host runs shard input files per host and write
result shards independently; JSONL output gives per-assembly idempotency for
stream resume.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import IO

from kaptive_tpu.core.genome import GenomeAssembly


def _load_and_index(
    path: str | Path | IO[bytes], multi_device: bool = False, pre_seed=None
) -> GenomeAssembly:
    from kaptive_tpu.utils.profiling import phase_timer

    # Two sub-phases (thread-wall time, sums across workers): ``parse_pack``
    # is the pure host CPU work — the number that decides whether ingest can
    # feed a faster device; ``h2d_wait`` is the blocked transfer.
    with phase_timer("ingest.parse_pack"):
        ga = GenomeAssembly.ensure(path)
        ga.get_minimizer_index()  # encode + pack on the ingest thread
        if pre_seed is not None:
            # Host-seeded mapping: run the C scan+match + chaining here on
            # the pool so the mapping phase finds the chains ready and the
            # packed genome never goes to the device at all.  The entry is
            # keyed by (gene_index, params) — the consumer re-seeds on a
            # mismatch rather than read chains built for another table.
            ci = ga.minimizer_index
            ci._cache["host_chains"] = pre_seed(ci)
            return ga
        from kaptive_tpu.ops.mapper import (
            _device_inputs,
            _device_inputs_sparse,
            _packed_inputs,
        )

        if multi_device:
            # The sharded-mesh mapper stacks HOST packed arrays itself and
            # device_puts them with shardings; pre-warm that host packing
            # here so it doesn't serialise into the mapping phase.
            _packed_inputs(ga.minimizer_index)
            return ga
        sparse = _device_inputs_sparse(ga.minimizer_index)
    import jax

    # Pre-upload the packed stream AND block on the copy here, so the
    # H2D genuinely lands while the device works on the current batch
    # (an unforced transfer can be deferred to the consumer's sync point,
    # serialising ~MBs per genome into the mapping phase).
    with phase_timer("ingest.h2d_wait"):
        if sparse is None:
            jax.block_until_ready(_device_inputs(ga.minimizer_index))
        else:
            jax.block_until_ready(sparse[:2])
    return ga


def stream_batches(
    genomes: Iterable[str | Path],
    batch_size: int = 8,
    prefetch_batches: int = 1,
    max_workers: int | None = None,
    multi_device: bool = False,
    pre_seed=None,
) -> Iterator[list[GenomeAssembly]]:
    r"""Yield fully-ingested assembly batches, prefetching ahead of the consumer."""
    genome_list = list(genomes)
    if not genome_list:
        return
    # Ramp-up: the stream's latency-to-first-dispatch is the FIRST batch's
    # full ingest (nothing overlaps it), so start with a quarter batch — the
    # device begins mapping ~4x sooner and every later ingest hides behind
    # compute.  Compiled shapes are batch-size independent (fixed scan
    # chunks, frozen DP lattices), so the odd first shape costs nothing.
    first = max(batch_size // 4, 1) if len(genome_list) > batch_size else batch_size
    bounds = [0, first] if first < len(genome_list) else [0, len(genome_list)]
    while bounds[-1] < len(genome_list):
        bounds.append(min(bounds[-1] + batch_size, len(genome_list)))
    groups = [genome_list[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
    if not groups:
        return
    # Pool sizing differs by mode.  Device-seeded ingest is GIL-releasing
    # numpy plus a BLOCKED H2D wait — the waits overlap freely, so the pool is
    # sized for them (16 threads).  Host-seeded ingest (pre_seed set) is pure CPU work
    # with no blocking waits: more threads than cores only adds scheduler
    # churn, so size to the machine.
    if max_workers is None:
        import os as _os

        max_workers = (
            max(2, min(16, _os.cpu_count() or 8)) if pre_seed is not None else 16
        )
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        pending = []
        for gi in range(min(prefetch_batches + 1, len(groups))):
            pending.append(
                [pool.submit(_load_and_index, g, multi_device, pre_seed) for g in groups[gi]]
            )
        next_submit = len(pending)
        for _ in range(len(groups)):
            futures = pending.pop(0)
            if next_submit < len(groups):
                pending.append(
                    [pool.submit(_load_and_index, g, multi_device, pre_seed) for g in groups[next_submit]]
                )
                next_submit += 1
            yield [f.result() for f in futures]


def auto_batch_size(per_device: int = 16) -> int:
    r"""Default assemblies per device batch: ``per_device`` x local device count.

    The device stages run in fixed 8-genome chunks regardless (compiled
    shapes are batch-size independent — ``ops/mapper.SCAN_CHUNK``); a larger
    streaming batch amortises the per-batch host glue and DP bucket padding.
    16 x 5 Mb assemblies per device fit easily in device memory.
    """
    try:
        import jax

        return per_device * max(jax.local_device_count(), 1)
    except Exception:
        return per_device


def stream_type(
    serotyper,
    genomes: Iterable[str | Path],
    batch_size: int = 8,
    prefetch_batches: int = 2,
    max_workers: int | None = None,
):
    r"""Generator of SerotypingResult over a streamed, prefetched genome list.

    Two-stage software pipeline: batch k+1's device mapping stage
    (``Serotyper.map_batch``, run on a single worker thread — JAX dispatch is
    thread-safe) overlaps batch k's decision stages
    (``Serotyper.finish_batch`` on this thread).  Every stage boundary waits
    in the shared device's work queue, so overlapping the waits recovers
    roughly a phase of latency per batch; results still stream in order.
    """
    mesh = getattr(serotyper, "mesh", None)
    multi = mesh is not None and int(mesh.devices.size) > 1
    pre_seed = None
    if not multi:
        from kaptive_tpu.ops.mapper import host_seed_chains, resolve_seed_mode

        if resolve_seed_mode() == "host":
            gene_index = serotyper._db.gene_index
            mp = serotyper.mapper_params
            gene_index.host_bloom  # build once before the pool fans out
            gene_index.host_buckets
            pre_seed = lambda ci: (gene_index, mp, host_seed_chains(gene_index, ci, mp))
    batches = stream_batches(
        genomes, batch_size, prefetch_batches, max_workers=max_workers,
        multi_device=multi, pre_seed=pre_seed,
    )
    with ThreadPoolExecutor(max_workers=1) as device_stage:
        pending = None  # (future over map_batch,) for the batch ahead
        for batch in batches:
            future = device_stage.submit(serotyper.map_batch, batch)
            if pending is not None:
                yield from serotyper.finish_batch(*pending.result())
            pending = future
        if pending is not None:
            yield from serotyper.finish_batch(*pending.result())
