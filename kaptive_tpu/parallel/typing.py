r"""Full-pipeline multi-chip typing: the REAL device stages under ``shard_map``.

This module shards the actual mapper device work (the minimizer scan/compact
and the bloom-gated table match of :mod:`kaptive_tpu.ops.mapper`) and the
banded-SWG sweeps over a ``(data, model)`` :class:`jax.sharding.Mesh`:

- **data axis** — assemblies: each device scans/matches its slice of the
  packed contig batch (the unit of parallelism is the reference's per-genome
  loop, ``/root/reference/src/kaptive/serotyping/cli.py:206-208``).
- **model axis** — the DB gene-minimizer table, sharded by hash range
  (contiguous slices of the hash-sorted table, each with its own prefix-bucket
  index and membership bitmap).  Every device matches its assembly slice
  against its table shard only; per-shard anchor sets are disjoint, so the
  merge is an ``all_gather`` over ``model`` followed by host concatenation.
  Chaining re-sorts anchors on composite keys, so the merged result is
  **bit-identical** to the single-device mapping (asserted in
  ``tests/test_parallel.py``).
- The extension/protein DP pair axis shards over every mesh device
  (``P(("data", "model"))``) — pairs are independent.

Multi-process: the same code runs under ``jax.distributed.initialize`` (see
:mod:`kaptive_tpu.parallel.multihost`); XLA lowers the collectives to NCCL.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kaptive_tpu.ops.mapper import (
    ANCHOR_CAP,
    BLOOM_BITS,
    BUCKET_SHIFT,
    CANDIDATE_CAP,
    DEVICE_MAX_OCC,
    _match_core,
    _scan_compact_core,
)
from kaptive_tpu.ops.minimizer import DEFAULT_K, DEFAULT_W

shard_map = jax.shard_map


def shard_cuts(sorted_hashes: np.ndarray, model: int) -> list[int]:
    r"""Even hash-range cut points for ``model`` table shards, aligned to
    hash-run boundaries.

    A run longer than ``max_occ`` straddling a cut would be capped per shard
    and merge to up to 2x the single-device occurrence cap, breaking
    bit-identity with the single-device matcher — so interior cuts advance to
    the next run start.  Also the basis for the work-balance analysis in
    ``tests/test_multichip_balance.py``.
    """
    n = len(sorted_hashes)
    cuts = [round(i * n / model) for i in range(model + 1)]
    for i in range(1, model):
        c = cuts[i]
        while 0 < c < n and sorted_hashes[c] == sorted_hashes[c - 1]:
            c += 1
        cuts[i] = max(min(c, n), cuts[i - 1])
    return cuts


@dataclass(frozen=True)
class ShardedGeneTable:
    r"""Hash-range shards of the gene minimizer table, stacked for ``P('model')``.

    Every per-shard array is padded to a common length so the stacked arrays
    split evenly over the ``model`` axis; pad entries use the maximum hash
    (matching no query — the bloom bitmap of each shard only covers its own
    entries).
    """

    hashes: np.ndarray  # (model * T_shard,) uint32
    genes: np.ndarray  # (model * T_shard,) int32
    positions: np.ndarray  # (model * T_shard,) int32
    strands: np.ndarray  # (model * T_shard,) bool
    bucket_starts: np.ndarray  # (model * (n_buckets + 1),) int32
    run_len: np.ndarray  # (model * T_shard,) int32
    bloom: np.ndarray  # (model * n_words,) uint32
    lookup_iters: int
    model: int

    @classmethod
    def build(cls, gene_index, model: int) -> "ShardedGeneTable":
        ms = gene_index.minimizers
        h = ms.hashes  # sorted
        n = len(h)
        cuts = shard_cuts(h, model)
        t_shard = max(max(cuts[i + 1] - cuts[i] for i in range(model)), 1)
        n_buckets = 1 << (32 - BUCKET_SHIFT)
        n_words = 1 << (BLOOM_BITS - 5)

        hashes = np.full((model, t_shard), np.uint32(0xFFFFFFFF), dtype=np.uint32)
        genes = np.zeros((model, t_shard), dtype=np.int32)
        positions = np.zeros((model, t_shard), dtype=np.int32)
        strands = np.zeros((model, t_shard), dtype=bool)
        bucket_starts = np.zeros((model, n_buckets + 1), dtype=np.int32)
        run_len = np.zeros((model, t_shard), dtype=np.int32)
        bloom = np.zeros((model, n_words), dtype=np.uint32)
        iters = 1
        for s in range(model):
            lo, hi = cuts[s], cuts[s + 1]
            span = hi - lo
            hashes[s, :span] = h[lo:hi]
            genes[s, :span] = ms.seq_indices[lo:hi]
            positions[s, :span] = ms.positions[lo:hi]
            strands[s, :span] = ms.strands[lo:hi]
            bucket_of = (hashes[s] >> np.uint32(BUCKET_SHIFT)).astype(np.int64)
            bucket_starts[s] = np.searchsorted(bucket_of, np.arange(n_buckets + 1)).astype(
                np.int32
            )
            occ = np.diff(bucket_starts[s])
            iters = max(iters, int(np.ceil(np.log2(max(int(occ.max()), 1) + 1))) + 1)
            _, inv, counts = np.unique(hashes[s], return_inverse=True, return_counts=True)
            run_len[s] = counts[inv].astype(np.int32)
            # pad entries share the max hash; cap their run length to the real span
            if span < t_shard:
                run_len[s, span:] = 0
            bits = (h[lo:hi].astype(np.uint64) & np.uint64((1 << BLOOM_BITS) - 1)).astype(
                np.int64
            )
            np.bitwise_or.at(bloom[s], bits >> 5, np.uint32(1) << (bits & 31).astype(np.uint32))
        return cls(
            hashes.reshape(-1), genes.reshape(-1), positions.reshape(-1),
            strands.reshape(-1), bucket_starts.reshape(-1), run_len.reshape(-1),
            bloom.reshape(-1), iters, model,
        )


def sharded_scan_match_chain(
    mesh: Mesh,
    packed: np.ndarray,  # (B, L // 4) uint8, B divisible by data axis
    bits: np.ndarray,  # (B, L // 8) uint8
    table: ShardedGeneTable,
    contig_starts: np.ndarray,  # (B, c_pad) int32 flat-stream contig starts
    gene_lengths: np.ndarray,  # (n_genes,) int32, replicated
    *,
    length: int,
    cap_mins: int,
    cap_cand: int = CANDIDATE_CAP,
    cap_anchors: int = ANCHOR_CAP,
    max_occ: int = DEVICE_MAX_OCC,
    k: int = DEFAULT_K,
    w: int = DEFAULT_W,
    cap_chains: int,
    max_diag_drift: int,
    max_anchor_gap: int,
    min_anchors: int = 1,
) -> tuple[np.ndarray, dict]:
    r"""Seeding stages + single-linkage chaining, all on the mesh.

    Round 2's sharded path downloaded the raw merged anchor buffers
    (``model * cap_anchors`` rows per genome) and chained on host; here the
    per-shard anchor sets are merged with the same ``all_gather`` and then
    chained **on device** (:func:`kaptive_tpu.ops.mapper._chain_core` vmapped
    over the data-local genomes), so only ``cap_chains`` chain descriptors per
    genome reach the host.  The chain output is bit-identical to the
    single-device chainer: chaining starts from a multi-key sort, so anchor
    order produced by the shard merge is irrelevant.

    Returns ``(chains (B, 10, cap_chains) int32, counts dict)`` where counts
    carries per-genome ``n_minimizers`` / ``n_candidates`` / ``n_anchors``
    (max over shards — each shard enforces the caps independently) and
    ``n_chains``.
    """
    from kaptive_tpu.ops.mapper import _ANCHOR_FIELDS, _CHAIN_FIELDS, _chain_core

    model = table.model
    iters = table.lookup_iters

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("data", None), P("data", None),
            P("model"), P("model"), P("model"), P("model"),
            P("model"), P("model"), P("model"),
            P("data", None), P(None),
        ),
        out_specs=(
            P("data", None, None), P("data"), P("data"),
            P("data"), P("data"), P("data"),
        ),
        check_vma=False,
    )
    def step(packed_s, bits_s, th, tg, tp, ts, bs, rl, bw, starts_s, glen):
        def one(p, e):
            pos, h, st, nm = _scan_compact_core(
                p, e, length=length, cap_mins=cap_mins, k=k, w=w
            )
            return _match_core(
                pos, h, st, nm, th, tg, tp, ts, bs, rl, bw,
                length=length, cap_cand=cap_cand, cap_anchors=cap_anchors,
                lookup_iters=iters, max_occ=max_occ,
            )

        local = jax.vmap(one)(packed_s, bits_s)
        # Disjoint per-shard anchor sets -> merge over the model axis:
        # (B_local, cap) -> (B_local, model * cap) per anchor field.
        merged = {
            key: jnp.moveaxis(
                jax.lax.all_gather(local[key], "model", axis=0), 0, 1
            ).reshape(local[key].shape[0], -1)
            for key in _ANCHOR_FIELDS
        }
        counts = {
            key: jnp.max(jax.lax.all_gather(local[key], "model", axis=0), axis=0)
            for key in ("n_minimizers", "n_candidates", "n_anchors")
        }

        def chain_one(anch, starts):
            d = dict(anch)
            d["valid"] = d["valid"].astype(bool)
            return _chain_core(
                d, starts, glen, k=k, cap_chains=cap_chains,
                max_diag_drift=max_diag_drift, max_anchor_gap=max_anchor_gap,
                min_anchors=min_anchors,
            )

        chains, n_chains, n_kept = jax.vmap(chain_one)(merged, starts_s)
        return (
            chains, n_chains.astype(jnp.int32), n_kept.astype(jnp.int32),
            counts["n_minimizers"], counts["n_candidates"], counts["n_anchors"],
        )

    def put(x, spec):
        return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))

    chains_d, n_chains, n_kept, n_mins, n_cand, n_anch = step(
        put(packed, P("data", None)), put(bits, P("data", None)),
        put(table.hashes, P("model")), put(table.genes, P("model")),
        put(table.positions, P("model")), put(table.strands, P("model")),
        put(table.bucket_starts, P("model")), put(table.run_len, P("model")),
        put(table.bloom, P("model")),
        put(contig_starts, P("data", None)),
        put(gene_lengths, P(None)),
    )
    assert len(_CHAIN_FIELDS) == chains_d.shape[1]
    counts = {
        "n_minimizers": np.asarray(n_mins),
        "n_candidates": np.asarray(n_cand),
        "n_anchors": np.asarray(n_anch),
        "n_chains": np.asarray(n_chains),
        "n_kept": np.asarray(n_kept),
    }
    return np.asarray(chains_d), counts


def device_count(mesh: Mesh | None) -> int:
    return int(mesh.devices.size) if mesh is not None else 1


def sharded_banded_swg(mesh: Mesh, q_mat, ql, t_mat, tl, do, kl, matrix, **statics):
    r"""Shard a padded banded-SWG bucket over every device of the mesh.

    Pairs are independent, so the batch axis shards over the flattened
    ``(data, model)`` device grid; each device runs the same (CUDA or lax)
    kernel on its slice.  The caller pads the batch to a multiple of the
    device count.
    """
    from kaptive_tpu.ops.swg import banded_swg
    from kaptive_tpu.platform import platform_of

    axis = ("data", "model")
    platform = platform_of(mesh.devices.flat[0])  # the mesh's, not the default device's
    matrix_np = np.asarray(matrix, dtype=np.int32)  # closed over: the kernel
    # front door inspects the matrix values on host to pick/compress the impl

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis, None), P(axis), P(axis), P(axis)),
        out_specs=jax.tree.map(lambda _: P(axis), _SWG_OUT_TEMPLATE),
        # The DP scan carries start as unvarying constants; skip the static
        # varying-axes check rather than pcast-ing inside the kernel.
        check_vma=False,
    )
    def step(q, l1, t, l2, offs, klocal):
        return banded_swg(q, l1, t, l2, offs, klocal, matrix_np, platform=platform, **statics)

    def put(x, spec):
        return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))

    return step(
        put(q_mat, P(axis, None)), put(ql, P(axis)),
        put(t_mat, P(axis, None)), put(tl, P(axis)),
        put(do, P(axis)), put(kl, P(axis)),
    )


def _swg_template():
    from kaptive_tpu.ops.swg import SwgResult

    return SwgResult(*([0] * 8))


_SWG_OUT_TEMPLATE = _swg_template()
