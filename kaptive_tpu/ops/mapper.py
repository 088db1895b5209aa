r"""Device gene-to-assembly nucleotide mapper: seed, chain, extend.

This replaces the reference's wrapped Rust ``rammappy`` (minimap2-class)
mapper invocation (``/root/reference/src/kaptive/serotyping/core.py:147-155``:
``Aligner(index=..., do_cigar=True)`` with dense all-hits options
``best_n=50000, pri_ratio=0.0``, consumed at ``core/alignment.py:391-474``).
It produces the same logical output per hit — query/target coordinates,
strand, matches, edit distance, score, mapq, primary flag — as flat SoA arrays
ready for :meth:`kaptive_tpu.core.alignment.Alignments.from_arrays`.

Pipeline (per assembly):

1. **Seed**: contig minimizers (device scan, :mod:`kaptive_tpu.ops.minimizer`)
   are looked up in the *static, hash-sorted DB gene minimizer table* (built
   once at DB pack time) — flipping the reference's per-genome contig index so
   the per-assembly work is pure streaming hash + binary search.  Anchors are
   (gene, gene_pos, contig, contig_pos, relative strand).
2. **Chain**: anchors are grouped by (gene, contig, strand) and single-linkage
   clustered on the alignment diagonal (``t_pos - q_pos`` forward,
   ``t_pos + q_pos`` reverse) with gap/diagonal-drift tolerances — one
   vectorised lexsort + prefix scan, no per-anchor Python.
3. **Extend**: each chain becomes one banded SWG problem — full gene (reverse-
   complemented for minus-strand chains) against a contig window projected
   from the chain, band sized to the chain's diagonal spread — batched through
   the same device DP kernel as the protein stage
   (:func:`kaptive_tpu.ops.swg.banded_swg`).

Dense-hits semantics: every chain above a small anchor threshold is extended
and reported (no per-query best-N pruning), mirroring the reference's
``best_n=50000, pri_ratio=0.0`` configuration.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from kaptive_tpu.core.alignment import Alignments
from kaptive_tpu.core.collections import ragged_gather_indices
from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.core.seq import Sequences
from kaptive_tpu.ops.minimizer import (
    DEFAULT_K,
    DEFAULT_W,
    ContigIndex,
    MinimizerSet,
    build_minimizer_set,
    concat_with_sentinels,
    encode_dna,
    minimizer_scan,
)
from kaptive_tpu.ops.rowscan import rowcompact_scan_xla

# Nucleotide scoring (minimap2-class defaults: match 2, mismatch -4, gap 4+2/base).
NT_MATCH = 2
NT_MISMATCH = -4
NT_GAP_OPEN = 4
NT_GAP_EXTEND = 2

_NT_MATRIX = np.full((256, 256), NT_MISMATCH, dtype=np.int32)
for _b in range(4):
    _NT_MATRIX[_b, _b] = NT_MATCH
_NT_MATRIX.flags.writeable = False


@dataclass(frozen=True, slots=True)
class GeneIndex:
    r"""Static, device-friendly index of the DB gene set (built once at pack time)."""

    minimizers: MinimizerSet  # hash-sorted over all genes
    codes: np.ndarray  # flat encoded gene sequences (with sentinels)
    starts: np.ndarray  # (n_genes,) start within codes
    lengths: np.ndarray  # (n_genes,)
    k: int
    w: int
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def build(cls, genes: Sequences, k: int = DEFAULT_K, w: int = DEFAULT_W) -> "GeneIndex":
        codes = encode_dna(genes.seqs)
        flat, starts = concat_with_sentinels(codes, genes.offsets, genes.lengths, k)
        mins = build_minimizer_set(genes, k=k, w=w, sort=True)
        return cls(mins, flat, starts, genes.lengths.astype(np.int64), k, w)

    @property
    def device_table(self):
        r"""Cached device copies of the sorted minimizer table arrays."""
        if "table" not in self._cache:
            import jax.numpy as jnp

            ms = self.minimizers
            self._cache["table"] = (
                jnp.asarray(ms.hashes),
                jnp.asarray(ms.seq_indices),
                jnp.asarray(ms.positions),
                jnp.asarray(ms.strands),
            )
        return self._cache["table"]

    @property
    def device_lookup(self):
        r"""Bucketed lookup acceleration structures (device-cached).

        A plain ``searchsorted`` into the table costs ~18 binary-search steps
        of random gathers per query — the dominant device cost of seeding.
        Restricting the search to hash-prefix buckets (host-precomputed starts)
        cuts the step count to ``ceil(log2(max bucket occupancy))``, and a
        per-entry run-length array replaces the second (right-side) search.
        """
        if "lookup" not in self._cache:
            import jax.numpy as jnp

            h = self.minimizers.hashes  # sorted uint32
            bucket_starts = self.host_buckets
            occupancy = np.diff(bucket_starts)
            iters = (
                int(np.ceil(np.log2(max(int(occupancy.max()), 1) + 1))) + 1 if len(h) else 1
            )
            # Run length of each entry's hash (for hi = lo + run_len at run starts).
            _, inv, counts = np.unique(h, return_inverse=True, return_counts=True)
            run_len = counts[inv].astype(np.int32)
            self._cache["lookup"] = (
                jnp.asarray(bucket_starts),
                jnp.asarray(run_len),
                max(iters, 1),
            )
        return self._cache["lookup"]

    @property
    def device_codes(self):
        r"""Device copy of the flat (sentinel-separated) gene code stream."""
        if "dev_codes" not in self._cache:
            import jax.numpy as jnp

            self._cache["dev_codes"] = jnp.asarray(self.codes)
        return self._cache["dev_codes"]

    @property
    def device_gene_lengths(self):
        r"""Device copy of per-gene lengths (for the device chainer)."""
        if "glen" not in self._cache:
            import jax.numpy as jnp

            self._cache["glen"] = jnp.asarray(self.lengths.astype(np.int32))
        return self._cache["glen"]

    @property
    def host_buckets(self) -> np.ndarray:
        r"""Hash-prefix bucket starts over the sorted table (host copy, cached).

        ``buckets[hash >> BUCKET_SHIFT] .. buckets[+1]`` bounds the table run
        of any hash — shared by the device match (:attr:`device_lookup`) and
        the native host seeding kernel, which both replace full-table binary
        searches with a per-bucket search of a few steps.
        """
        if "buckets_np" not in self._cache:
            h = self.minimizers.hashes  # sorted uint32
            n_buckets = 1 << (32 - BUCKET_SHIFT)
            bucket_of = (h >> np.uint32(BUCKET_SHIFT)).astype(np.int64)
            self._cache["buckets_np"] = np.searchsorted(
                bucket_of, np.arange(n_buckets + 1)
            ).astype(np.int32)
        return self._cache["buckets_np"]

    @property
    def host_bloom(self) -> np.ndarray:
        r"""Membership bitmap over table hashes (host copy, cached).

        Contig minimizers overwhelmingly miss the gene table (the table covers
        ~0.5 Mb of genes vs ~5 Mb of genome), so the expensive per-query binary
        search is gated behind a single bitmap test: bit
        ``hash & (2^BLOOM_BITS - 1)`` is set for every table hash.  False
        positives (~table_size / 2^BLOOM_BITS) only cost a wasted search slot.
        """
        if "bloom_np" not in self._cache:
            h = self.minimizers.hashes.astype(np.uint64)
            bit = (h & np.uint64((1 << BLOOM_BITS) - 1)).astype(np.int64)
            words = np.zeros(1 << (BLOOM_BITS - 5), dtype=np.uint32)
            np.bitwise_or.at(words, bit >> 5, np.uint32(1) << (bit & 31).astype(np.uint32))
            self._cache["bloom_np"] = words
        return self._cache["bloom_np"]

    @property
    def device_bloom(self):
        r"""Device copy of :attr:`host_bloom` (gates the device match stage)."""
        if "bloom" not in self._cache:
            import jax.numpy as jnp

            self._cache["bloom"] = jnp.asarray(self.host_bloom)
        return self._cache["bloom"]


@dataclass(frozen=True, slots=True)
class MapperParams:
    r"""Tunables for the seed-chain-extend pipeline."""

    min_anchors: int = 2  # chains with fewer anchors are dropped
    max_diag_drift: int = 100  # single-linkage diagonal tolerance within a chain
    max_anchor_gap: int = 2000  # positional gap tolerance within a chain
    band_slack: int = 48  # extra half-band beyond the chain's diagonal spread
    window_pad: int = 64  # extra target window around the projected gene span
    min_score: int = 30  # discard extensions below this SW score
    max_occ: int = 1024  # per-contig-minimizer occurrence cap in the gene table
    emit_cigars: bool = False  # record BAM CIGARs during extension traceback
    # (the reference maps with do_cigar=True; typing decisions never read them,
    # so the default keeps the faster count-only traceback)
    lattice: object = None  # optional SwgLattice freezing the extension-DP shapes


def find_anchors(gene_index: GeneIndex, contig_mins: MinimizerSet, params: MapperParams):
    r"""Match contig minimizers against the sorted gene table -> anchor arrays (host path)."""
    h = contig_mins.hashes
    lo = np.searchsorted(gene_index.minimizers.hashes, h, side="left")
    hi = np.searchsorted(gene_index.minimizers.hashes, h, side="right")
    counts = np.minimum(hi - lo, params.max_occ)
    if counts.sum() == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z, z, z, z
    flat_idx, _, out_lengths = ragged_gather_indices(lo, counts)
    rep = np.repeat(np.arange(len(h)), out_lengths)

    g_idx = gene_index.minimizers.seq_indices[flat_idx].astype(np.int64)
    g_pos = gene_index.minimizers.positions[flat_idx].astype(np.int64)
    g_strand = gene_index.minimizers.strands[flat_idx]
    c_idx = contig_mins.seq_indices[rep].astype(np.int64)
    c_pos = contig_mins.positions[rep].astype(np.int64)
    c_strand = contig_mins.strands[rep]

    rel_strand = np.where(g_strand == c_strand, 1, -1).astype(np.int64)
    return g_idx, g_pos, c_idx, c_pos, rel_strand


def resolve_seed_mode(requested: str | None = None) -> str:
    r"""Resolve the seeding mode: ``"host"`` or ``"device"``.

    ``KAPTIVE_SEED_MODE`` (or the explicit argument) forces a mode; ``auto``
    picks HOST seeding when the native scanner is built and the default JAX
    device is a GPU: there the C scan runs on the ingest pool, overlapped
    with device compute, and the per-genome H2D shrinks from the packed
    stream to the DP problem windows.  On the CPU the device-scan path stays
    the default so the jitted scan/match/chain programs keep their test
    coverage.  Both modes give identical rows.
    """
    mode = requested or os.environ.get("KAPTIVE_SEED_MODE", "auto")
    if mode in ("host", "device"):
        return mode
    try:
        from kaptive_tpu.native import hostio

        if not hasattr(hostio, "seed_anchors"):
            return "device"
    except ImportError:
        return "device"
    from kaptive_tpu.platform import on_gpu

    return "host" if on_gpu() else "device"


def host_seed_chains(gene_index: GeneIndex, contig_index, params: MapperParams) -> dict:
    r"""Host half of the seed stage: anchors + chains for ONE assembly.

    Native C scan+match (:func:`kaptive_tpu.native.hostio.seed_anchors`,
    bloom-gated) when built, else the numpy :func:`find_anchors` path — both
    produce the exact anchor set of the device scan/match stages, then chain
    with :func:`chain_anchors`.  Ingest worker threads call this ahead of the
    mapping phase so seeding fully overlaps device compute.
    """
    from kaptive_tpu.utils.metrics import count as _count

    tm = gene_index.minimizers
    try:
        from kaptive_tpu.native import hostio

        ti, cpos, cstrand, n_min, n_cand = hostio.seed_anchors(
            contig_index.codes, gene_index.k, gene_index.w, tm.hashes,
            min(params.max_occ, DEVICE_MAX_OCC),
            bloom_words=gene_index.host_bloom, bloom_bits=BLOOM_BITS,
            bucket_starts=gene_index.host_buckets, bucket_shift=BUCKET_SHIFT,
        )
        _count("map.host_seed.native")
        c_idx = np.searchsorted(contig_index.starts, cpos, side="right") - 1
        anchors = (
            tm.seq_indices[ti].astype(np.int64),
            tm.positions[ti].astype(np.int64),
            c_idx.astype(np.int64),
            (cpos - contig_index.starts[c_idx]).astype(np.int64),
            np.where(tm.strands[ti] == cstrand.astype(bool), 1, -1).astype(np.int64),
        )
    except ImportError:
        _count("map.host_seed.numpy")
        anchors = find_anchors(gene_index, contig_index.minimizers, params)
    return chain_anchors(*anchors, gene_index.lengths, gene_index.k, params)


MIN_DENSITY_CAP = 4  # minimizer capacity = L / MIN_DENSITY_CAP (true density ~2/(w+1))
# Fixed-capacity buffers: every expansion pass (cumsum/cummax/gather) costs
# time proportional to the CAP, not the live count, so the caps sit ~4-10x
# above typical occupancy (measured ~5K candidates / ~3.5K anchors per 5.3 Mb
# genome) rather than ~20x; overflow fires the counted host fallback.
CANDIDATE_CAP = 1 << 14  # per-genome bloom-surviving minimizer capacity
# The chain stage's 6-key lax.sort runs over the full anchor buffer, so its
# cost scales with this CAPACITY, not live anchors — 16K is ~4.7x measured
# occupancy and halved the chain stage vs the earlier 32K.
ANCHOR_CAP = 1 << 14  # per-genome anchor capacity (transferred arrays scale with this)
DEVICE_MAX_OCC = 1024  # ceiling on MapperParams.max_occ in the fused device
# step (the device paths honour min(params.max_occ, DEVICE_MAX_OCC) so a
# non-default setting behaves identically on the device and host-fallback
# paths; buffers are sized for the ceiling)
BUCKET_SHIFT = 12  # hash-prefix bucket width for the device table lookup (2^20 buckets)
BLOOM_BITS = 27  # membership bitmap size (2^27 bits = 16 MB); FP rate = T / 2^27


def bucketed_first_ge(table_hashes, bucket_starts, queries, iters: int):
    r"""First index in sorted ``table_hashes`` >= query, restricted per hash-prefix bucket."""
    b = (queries >> jnp.uint32(BUCKET_SHIFT)).astype(jnp.int32)
    lo = bucket_starts[b]
    hi = bucket_starts[b + 1]
    for _ in range(iters):
        mid = (lo + hi) // 2
        go = table_hashes[jnp.minimum(mid, table_hashes.shape[0] - 1)] < queries
        lo = jnp.where((mid < hi) & go, mid + 1, lo)
        hi = jnp.where((mid < hi) & ~go, mid, hi)
    return lo


def _scan_compact_core(packed, valid_bits, *, length: int, cap_mins: int, k: int, w: int):
    r"""Stage A: unpack -> minimizer scan -> fixed-capacity compaction."""
    from kaptive_tpu.ops.minimizer import unpack_2bit_with_bits

    L = length
    codes = unpack_2bit_with_bits(packed, valid_bits, L)
    sel, hashes, strands = minimizer_scan(codes, k, w)
    # Compact selected positions into [cap_mins] slots.  Ranks are unique for
    # selected positions, so the scatter carries unique_indices; everything
    # else targets an out-of-bounds slot and is dropped.
    rank = jnp.cumsum(sel.astype(jnp.int32)) - 1
    DROP = jnp.int32(0x40000000)
    scatter_to = jnp.where(sel & (rank < cap_mins), rank, DROP)
    pos = (
        jnp.full(cap_mins, L, dtype=jnp.int32)
        .at[scatter_to]
        .set(jnp.arange(L, dtype=jnp.int32), mode="drop", unique_indices=True)
    )
    ok_min = pos < L
    safe_pos = jnp.minimum(pos, L - 1)
    h = jnp.where(ok_min, hashes[safe_pos], jnp.uint32(0xFFFFFFFF))
    st = strands[safe_pos]
    return pos, h, st, sel.sum()


def _match_core(
    pos, h, st, n_minimizers,
    table_hashes, table_genes, table_pos, table_strands, bucket_starts, run_len,
    bloom_words,
    *, length: int, cap_cand: int, cap_anchors: int, lookup_iters: int, max_occ: int,
):
    r"""Stage B: bloom prefilter -> candidate compaction -> bucketed table
    lookup -> ragged occurrence expansion -> anchors.

    The prefilter replaces ~``lookup_iters`` random table gathers per contig
    minimizer (millions) with ONE bitmap gather; only the surviving candidates
    (locus-region minimizers plus ~0.4% false positives) pay the search.
    """
    L = length
    T = table_hashes.shape[0]
    cap_mins = pos.shape[0]
    ok_min = pos < L

    # Prefilter: single gather into the membership bitmap per minimizer.
    bit = (h & jnp.uint32((1 << BLOOM_BITS) - 1)).astype(jnp.int32)
    word = bloom_words[bit >> 5]
    maybe = ok_min & (((word >> (bit & 31).astype(jnp.uint32)) & 1) == 1)

    # Compact candidates to a fixed-width buffer (unique-rank drop-scatter).
    rank = jnp.cumsum(maybe.astype(jnp.int32)) - 1
    n_candidates = rank[-1] + 1
    DROP = jnp.int32(0x40000000)
    slot = jnp.where(maybe & (rank < cap_cand), rank, DROP)
    c_pos = (
        jnp.full(cap_cand, L, dtype=jnp.int32)
        .at[slot].set(pos, mode="drop", unique_indices=True)
    )
    c_h = (
        jnp.full(cap_cand, jnp.uint32(0xFFFFFFFF))
        .at[slot].set(h, mode="drop", unique_indices=True)
    )
    c_st = (
        jnp.zeros(cap_cand, dtype=st.dtype)
        .at[slot].set(st, mode="drop", unique_indices=True)
    )
    ok_cand = c_pos < L

    lo = bucketed_first_ge(table_hashes, bucket_starts, c_h, lookup_iters)
    exact = table_hashes[jnp.minimum(lo, T - 1)] == c_h
    n_hits = jnp.where(exact & (lo < T), run_len[jnp.minimum(lo, T - 1)], 0)
    counts = jnp.where(ok_cand, jnp.minimum(n_hits, max_occ), 0).astype(jnp.int32)

    cum = jnp.cumsum(counts) - counts
    total = cum[-1] + counts[-1]
    j = jnp.arange(cap_anchors, dtype=jnp.int32)
    mi = jnp.searchsorted(cum, j, side="right") - 1
    mi = jnp.clip(mi, 0, cap_cand - 1)
    within = j - cum[mi]
    ok_a = (j < total) & (within >= 0) & (within < counts[mi])
    ti = jnp.clip(lo[mi] + within, 0, T - 1)

    return dict(
        valid=ok_a,
        c_flat_pos=jnp.where(ok_a, c_pos[mi], 0).astype(jnp.int32),
        c_strand=c_st[mi],
        g_idx=jnp.where(ok_a, table_genes[ti], 0).astype(jnp.int32),
        g_pos=jnp.where(ok_a, table_pos[ti], 0).astype(jnp.int32),
        g_strand=table_strands[ti],
        n_minimizers=n_minimizers,
        n_candidates=n_candidates,
        n_anchors=total,
    )


_ANCHOR_FIELDS = ("valid", "c_flat_pos", "c_strand", "g_idx", "g_pos", "g_strand")
_COUNT_FIELDS = ("n_minimizers", "n_candidates", "n_anchors")


# --- row-compact seeding path (fused row scan + gather-light match) ---------
#
# The full-genome seeding path above streams ~60 full-genome arrays through
# HBM and compacts 8M positions with a scatter; the row-compact path
# (ops/rowscan.py) compacts per 128-position row with streaming elementwise
# work, and its match stage never touches an 8M-scale gather/scatter: the
# only full-width random-memory op left is the bloom-membership gather over
# the (rows, 32) minimizer slots.


@functools.partial(jax.jit, static_argnames=("length",))
def _unpack_batch(packed, bits, *, length: int):
    from kaptive_tpu.ops.rowscan import unpack_to_padded

    padded = jax.vmap(lambda p, e: unpack_to_padded(p, e, length))(packed, bits)
    # The flattened padded streams stay device-resident for the extension-DP
    # stage (device-side problem materialisation — no target-window H2D).
    return padded, padded.reshape(-1)


@functools.partial(jax.jit, static_argnames=("length",))
def _unpack_batch_sparse(packed_q, exc_q, real_lens, *, length: int):
    from kaptive_tpu.ops.rowscan import unpack_sparse_to_padded

    padded = jax.vmap(
        lambda p, e, r: unpack_sparse_to_padded(p, e, r, length)
    )(packed_q, exc_q, real_lens)
    return padded, padded.reshape(-1)


def _rowcompact_batch(packed, bits, *, length: int, k: int, w: int):
    r"""Unpack + row-compact minimizer scan (dense-upload form)."""
    padded, flat_codes = _unpack_batch(packed, bits, length=length)
    return (*rowcompact_scan_xla(padded, k, w), flat_codes)


FOLD_ROWS = 16  # 128-position scan rows folded per bloom/search row
FOLD_SLOTS = 512  # live capacity per folded row; lambda ~ 373, P(X>512) ~ 1e-12


def _match_rows_core(
    h_rows, aux_rows, counts,
    table_hashes, table_genes, table_pos, table_strands, bucket_starts, run_len,
    bloom_words,
    *, cap_cand: int, cap_anchors: int, lookup_iters: int, max_occ: int,
):
    r"""Match row-compacted minimizers against the gene table.

    The bloom-membership gather is the match stage's dominant cost and
    scales with SLOT COUNT, not live minimizers, so the scan's (R, 64) rows
    are first folded 16:1 and re-compacted to (R/16, 512) — half the tested
    slots at ~2.7x better fill — before the single bloom gather per slot.
    All expansion steps use scatter+cummax segment fills over fixed-capacity
    buffers (64K-scale) instead of ``searchsorted`` over large arrays.
    (Both choices were made for a device where gathers serialise per
    element; whether they pay on the GPU is for a benchmark cell to decide.)
    """
    from kaptive_tpu.ops.rowscan import ROW, SLOTS, compact_lanes

    R = h_rows.shape[0]
    T = table_hashes.shape[0]
    DROP = jnp.int32(0x40000000)
    MAXU = jnp.uint32(0xFFFFFFFF)

    # Fold: pack each slot's fold-local row index into aux bits 8.. (col uses
    # bits 0-6, strand bit 7), reshape 16 rows into one 1024-lane row, and
    # butterfly-compact the live slots to the front.
    ok = h_rows != MAXU
    local = (
        jax.lax.broadcasted_iota(jnp.int32, (R, SLOTS), 0) % FOLD_ROWS
    )
    aux2 = aux_rows | (local << 8)
    Rf = R // FOLD_ROWS
    okf = ok.reshape(Rf, FOLD_ROWS * SLOTS)
    hf = h_rows.reshape(Rf, FOLD_ROWS * SLOTS)
    af = aux2.reshape(Rf, FOLD_ROWS * SLOTS)
    livef, (hq, aq), fold_cnt = compact_lanes(okf, (hf, af), FOLD_ROWS * SLOTS, FOLD_SLOTS)
    hq = jnp.where(livef, hq, MAXU)
    fold_overflow = (fold_cnt[:, 0] > FOLD_SLOTS).any()

    bit = (hq & jnp.uint32((1 << BLOOM_BITS) - 1)).astype(jnp.int32)
    word = bloom_words[bit >> 5]
    maybe = livef & (((word >> (bit & 31).astype(jnp.uint32)) & 1) == 1)

    # Compact bloom survivors within each folded row (streaming butterfly).
    live, (hc, auxc), _ = compact_lanes(maybe, (hq, aq), FOLD_SLOTS, FOLD_SLOTS)
    row_cnt = jnp.sum(maybe.astype(jnp.int32), axis=-1)  # (Rf,)

    # Expand rows -> flat candidate list via scatter + cummax segment fill.
    offs = jnp.cumsum(row_cnt) - row_cnt
    n_cand = offs[-1] + row_cnt[-1]
    slot = jnp.where(row_cnt > 0, offs, DROP)
    owner = (
        jnp.zeros(cap_cand, jnp.int32)
        .at[slot].max(jnp.arange(Rf, dtype=jnp.int32), mode="drop")
    )
    owner = jax.lax.cummax(owner)
    j = jnp.arange(cap_cand, dtype=jnp.int32)
    within = j - offs[owner]
    ok_c = (j < n_cand) & (within >= 0) & (within < row_cnt[owner])
    flat_idx = owner * FOLD_SLOTS + jnp.clip(within, 0, FOLD_SLOTS - 1)
    c_h = jnp.where(ok_c, hc.reshape(-1)[flat_idx], MAXU)
    c_aux = jnp.where(ok_c, auxc.reshape(-1)[flat_idx], 0)
    c_pos = (
        owner * (FOLD_ROWS * ROW)
        + ((c_aux >> 8) & (FOLD_ROWS - 1)) * ROW
        + (c_aux & (ROW - 1))
    )
    c_strand = (c_aux >> 7) & 1

    # Bucketed binary search over the (small) candidate set.
    lo = bucketed_first_ge(table_hashes, bucket_starts, c_h, lookup_iters)
    exact = table_hashes[jnp.minimum(lo, T - 1)] == c_h
    n_hits = jnp.where(exact & (lo < T), run_len[jnp.minimum(lo, T - 1)], 0)
    cnt2 = jnp.where(ok_c, jnp.minimum(n_hits, max_occ), 0).astype(jnp.int32)

    # Expand candidates -> anchors (same scatter + cummax fill).
    cum2 = jnp.cumsum(cnt2) - cnt2
    total = cum2[-1] + cnt2[-1]
    slot2 = jnp.where(cnt2 > 0, cum2, DROP)
    owner2 = (
        jnp.zeros(cap_anchors, jnp.int32)
        .at[slot2].max(jnp.arange(cap_cand, dtype=jnp.int32), mode="drop")
    )
    owner2 = jax.lax.cummax(owner2)
    j2 = jnp.arange(cap_anchors, dtype=jnp.int32)
    within2 = j2 - cum2[owner2]
    ok_a = (j2 < total) & (within2 >= 0) & (within2 < cnt2[owner2])
    ti = jnp.clip(lo[owner2] + within2, 0, T - 1)

    return dict(
        valid=ok_a,
        c_flat_pos=jnp.where(ok_a, c_pos[owner2], 0).astype(jnp.int32),
        c_strand=c_strand[owner2],
        g_idx=jnp.where(ok_a, table_genes[ti], 0).astype(jnp.int32),
        g_pos=jnp.where(ok_a, table_pos[ti], 0).astype(jnp.int32),
        g_strand=table_strands[ti],
        n_minimizers=counts.sum(),
        n_candidates=n_cand,
        n_anchors=total,
        row_overflow=((counts > SLOTS).any() | fold_overflow).astype(jnp.int32),
    )


_ROW_COUNT_FIELDS = ("n_minimizers", "n_candidates", "n_anchors", "row_overflow")


def _pack_match_rows_output(d: dict):
    anchors = jnp.stack([d[k].astype(jnp.int32) for k in _ANCHOR_FIELDS])
    counts = jnp.stack([d[k].astype(jnp.int32) for k in _ROW_COUNT_FIELDS])
    return anchors, counts


_match_rows_batch = jax.jit(
    lambda h, a, c, th, tg, tp, ts, bs, rl, bw, cap_cand, cap_anchors, iters, max_occ: _pack_match_rows_output(
        jax.vmap(
            lambda hh, aa, cc: _match_rows_core(
                hh, aa, cc, th, tg, tp, ts, bs, rl, bw,
                cap_cand=cap_cand, cap_anchors=cap_anchors,
                lookup_iters=iters, max_occ=max_occ,
            )
        )(h, a, c)
    ),
    static_argnums=(10, 11, 12, 13),
)


CHAIN_CAP = 4096  # per-genome chain capacity for the device chainer
CHAIN_PREFIX = 512  # chain rows pulled in the batched D2H (full pull past this)


# Genomes per scan/match/chain dispatch (fixed: batch-size-proof shapes).
# Two chunks per 16-genome batch let the first chunk's extension DP dispatch
# overlap the second chunk's scan, which one monolithic chunk forfeits.
SCAN_CHUNK = 8

_CHAIN_FIELDS = (
    "gene", "ctg", "strand", "count",
    "t_min", "t_max", "q_min", "q_max", "d_min", "d_max",
)


def _chain_core(
    anchors: dict, contig_starts, gene_lengths,
    *, k: int, cap_chains: int, max_diag_drift: int, max_anchor_gap: int,
    min_anchors: int = 1,
):
    r"""Device single-linkage chaining (mirrors :func:`chain_anchors`).

    One multi-key sort + shifted compares + segment scatters over the 64K
    anchor buffer; emits fixed-capacity chain descriptor arrays so only
    ~``cap_chains`` rows ever reach the host (the raw anchor buffer —
    hundreds of times larger — stays device-resident).  Chains below
    ``min_anchors`` (mostly 1-anchor noise from random shared minimizers, the
    bulk of all chains) are compacted out on device, so the live prefix the
    host pulls stays small.  Returns ``(fields, n_chains_raw, n_kept)`` —
    the raw count drives overflow detection, the kept count the host pull.
    """
    BIG = jnp.int32(0x7FFFFFFF)
    DROP = jnp.int32(0x40000000)
    valid = anchors["valid"]
    flat_pos = anchors["c_flat_pos"]
    c_idx = jnp.searchsorted(contig_starts, flat_pos, side="right").astype(jnp.int32) - 1
    c_local = flat_pos - contig_starts[c_idx]
    rel = jnp.where(anchors["g_strand"] == anchors["c_strand"], 1, -1).astype(jnp.int32)
    glen = gene_lengths[anchors["g_idx"]]
    qp = jnp.where(rel > 0, anchors["g_pos"], glen - k - anchors["g_pos"])
    diag = c_local - qp

    g_sort = jnp.where(valid, anchors["g_idx"], BIG)
    gs, cs, ss, ds, ts, qs = jax.lax.sort(
        (g_sort, c_idx, rel, diag, c_local, qp), num_keys=5
    )
    valid_s = gs != BIG
    first = jnp.zeros(gs.shape, bool).at[0].set(True)
    prev = lambda x: jnp.roll(x, 1)
    new_group = first | (gs != prev(gs)) | (cs != prev(cs)) | (ss != prev(ss))
    brk = new_group
    brk = brk | ((ds - prev(ds)) > max_diag_drift)
    brk = brk | (jnp.abs(ts - prev(ts)) > max_anchor_gap)
    brk = brk & valid_s
    chain_id = jnp.cumsum(brk.astype(jnp.int32)) - 1
    n_chains = brk.sum()

    cid = jnp.where(valid_s & (chain_id < cap_chains) & (chain_id >= 0), chain_id, DROP)

    def seg_min(x):
        return jnp.full(cap_chains, BIG, jnp.int32).at[cid].min(x, mode="drop")

    def seg_max(x):
        return jnp.full(cap_chains, -BIG, jnp.int32).at[cid].max(x, mode="drop")

    out = dict(
        gene=seg_max(gs), ctg=seg_max(cs), strand=seg_max(ss),
        count=jnp.zeros(cap_chains, jnp.int32).at[cid].add(1, mode="drop"),
        t_min=seg_min(ts), t_max=seg_max(ts),
        q_min=seg_min(qs), q_max=seg_max(qs),
        d_min=seg_min(ds), d_max=seg_max(ds),
    )
    # Compact qualifying chains to the front (unique-rank drop-scatter).
    # Clamp the threshold to >= 1: dead buffer rows carry count 0, and
    # min_anchors=0 ("keep everything") means every REAL chain, which by
    # definition has at least one anchor (the host chainer agrees).
    keep = out["count"] >= max(min_anchors, 1)
    rank = jnp.cumsum(keep.astype(jnp.int32)) - 1
    slot = jnp.where(keep, rank, DROP)

    def compact(x):
        return (
            jnp.zeros(cap_chains, jnp.int32)
            .at[slot].set(x, mode="drop", unique_indices=True)
        )

    return (
        jnp.stack([compact(out[f]) for f in _CHAIN_FIELDS]),
        n_chains,
        keep.sum(),
    )


def _chain_batch_impl(
    anchors, counts, contig_starts, gene_lengths,
    k, cap_chains, max_diag_drift, max_anchor_gap, min_anchors,
):
    def per_genome(anch, starts):
        d = {key: anch[i] for i, key in enumerate(_ANCHOR_FIELDS)}
        d["valid"] = d["valid"].astype(bool)
        return _chain_core(
            d, starts, gene_lengths,
            k=k, cap_chains=cap_chains,
            max_diag_drift=max_diag_drift, max_anchor_gap=max_anchor_gap,
            min_anchors=min_anchors,
        )

    chains, n_chains, n_kept = jax.vmap(per_genome, in_axes=(1, 0))(
        anchors, contig_starts
    )
    return chains, jnp.concatenate(
        [counts, n_chains[None, :].astype(jnp.int32), n_kept[None, :].astype(jnp.int32)],
        axis=0,
    )


_chain_batch = jax.jit(_chain_batch_impl, static_argnums=(4, 5, 6, 7, 8))


def _packed_inputs(contig_index) -> tuple[np.ndarray, np.ndarray, int]:
    r"""2-bit packed stream + bit-packed validity mask for device upload (cached)."""
    from kaptive_tpu.ops.minimizer import pack_2bit, pack_valid_bits

    if "packed" not in contig_index._cache:
        contig_index._cache["packed"] = pack_2bit(contig_index.codes)
        contig_index._cache["bits"] = pack_valid_bits(contig_index.codes)
    return contig_index._cache["packed"], contig_index._cache["bits"], int(
        contig_index.codes.shape[0]
    )


def _device_inputs(contig_index):
    r"""Device copies of the packed stream (cached).

    Ingest threads call this ahead of time so the host->device upload of the
    NEXT batch overlaps the current batch's compute instead of serialising
    inside the mapping phase.
    """
    if "dev_packed" not in contig_index._cache:
        pb, vb, _ = _packed_inputs(contig_index)
        contig_index._cache["dev_packed"] = jnp.asarray(pb)
        contig_index._cache["dev_bits"] = jnp.asarray(vb)
    return contig_index._cache["dev_packed"], contig_index._cache["dev_bits"]


from kaptive_tpu.ops.minimizer import EXC_CAP  # sparse-upload exception capacity


def _quantised_sparse(packed: np.ndarray, exc: np.ndarray, real: int):
    r"""Quantise the sparse upload arrays so jit keys stay stable (packed
    width in 256 KiB steps, exception list in pow4 steps)."""
    step = 1 << 18
    w4 = max(-(-len(packed) // step) * step, step)
    packed_q = np.zeros(w4, dtype=np.uint8)
    packed_q[: len(packed)] = packed
    e_q = 1024
    while e_q < len(exc):
        e_q *= 4
    exc_q = np.full(e_q, np.int32(0x40000000), dtype=np.int32)
    exc_q[: len(exc)] = exc
    return packed_q, exc_q, np.int32(real)


def _packed_inputs_sparse(contig_index):
    r"""Sparse host upload form: (packed_real_q, exceptions_q, real_len).

    Uploads only the real-prefix 2-bit stream plus the positions of invalid
    bases — the dense validity bitmask and the bucket padding were ~58% of
    the H2D bytes for nothing.  Returns None when the assembly has more than
    ``EXC_CAP`` invalid positions (callers fall back to the dense form).
    The native ingest path (``ContigIndex.build``) pre-computes the pack and
    exception scan in one C pass; the numpy form is the fallback.
    """
    if "sparse" not in contig_index._cache:
        native = contig_index._cache.pop("native_pack", None)
        if native is not None:
            packed, exc, real, n_exc = native
            contig_index._cache["sparse"] = (
                None if n_exc > EXC_CAP else _quantised_sparse(packed, exc, real)
            )
        else:
            starts, lengths = contig_index.starts, contig_index.lengths
            real = int(starts[-1] + lengths[-1]) if len(starts) else 0
            n4 = (real + 3) // 4 * 4
            codes_real = contig_index.codes[:n4]
            exc = np.flatnonzero(codes_real >= 4).astype(np.int32)
            if len(exc) > EXC_CAP:
                contig_index._cache["sparse"] = None
            else:
                from kaptive_tpu.ops.minimizer import pack_2bit

                contig_index._cache["sparse"] = _quantised_sparse(
                    pack_2bit(codes_real), exc, real
                )
    return contig_index._cache["sparse"]


def _device_inputs_sparse(contig_index):
    r"""Device copies of the sparse upload form (cached; None = use dense).

    Ingest threads call this ahead of time and block on the transfer so the
    H2D of the NEXT batch genuinely overlaps the current batch's compute.
    """
    if "dev_sparse" not in contig_index._cache:
        sp = _packed_inputs_sparse(contig_index)
        if sp is None:
            contig_index._cache["dev_sparse"] = None
        else:
            p, e, r = sp
            contig_index._cache["dev_sparse"] = (jnp.asarray(p), jnp.asarray(e), r)
    return contig_index._cache["dev_sparse"]


def chain_anchors(
    g_idx: np.ndarray,
    g_pos: np.ndarray,
    c_idx: np.ndarray,
    c_pos: np.ndarray,
    rel_strand: np.ndarray,
    gene_lengths: np.ndarray,
    k: int,
    params: MapperParams,
):
    r"""Vectorised single-linkage chaining on the alignment diagonal.

    For minus-strand anchors the gene coordinate is flipped to the
    reverse-complement frame (``q' = gene_len - k - q``) so both strands chain
    on ``diag = t_pos - q'``.
    """
    n = len(g_idx)
    if n == 0:
        return {}
    glen = gene_lengths[g_idx]
    q_prime = np.where(rel_strand > 0, g_pos, glen - k - g_pos)
    diag = c_pos - q_prime

    order = np.lexsort((c_pos, diag, rel_strand, c_idx, g_idx))
    gs, qs, cs, ts, ss, ds = (
        g_idx[order], q_prime[order], c_idx[order], c_pos[order], rel_strand[order], diag[order]
    )
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    new_group[1:] = (gs[1:] != gs[:-1]) | (cs[1:] != cs[:-1]) | (ss[1:] != ss[:-1])
    brk = new_group.copy()
    brk[1:] |= (ds[1:] - ds[:-1]) > params.max_diag_drift
    brk[1:] |= np.abs(ts[1:] - ts[:-1]) > params.max_anchor_gap
    chain_ids = np.cumsum(brk) - 1
    n_chains = chain_ids[-1] + 1

    def seg_reduce(vals, fn, init):
        out = np.full(n_chains, init, dtype=np.int64)
        fn.at(out, chain_ids, vals)
        return out

    first_of_chain = np.flatnonzero(brk)
    c_gene = gs[first_of_chain]
    c_ctg = cs[first_of_chain]
    c_strand = ss[first_of_chain]
    c_count = np.bincount(chain_ids, minlength=n_chains)
    c_tmin = seg_reduce(ts, np.minimum, np.iinfo(np.int64).max)
    c_tmax = seg_reduce(ts, np.maximum, np.iinfo(np.int64).min)
    c_qmin = seg_reduce(qs, np.minimum, np.iinfo(np.int64).max)
    c_qmax = seg_reduce(qs, np.maximum, np.iinfo(np.int64).min)
    c_dmin = seg_reduce(ds, np.minimum, np.iinfo(np.int64).max)
    c_dmax = seg_reduce(ds, np.maximum, np.iinfo(np.int64).min)

    keep = c_count >= params.min_anchors
    return {
        "gene": c_gene[keep], "ctg": c_ctg[keep], "strand": c_strand[keep],
        "count": c_count[keep], "t_min": c_tmin[keep], "t_max": c_tmax[keep],
        "q_min": c_qmin[keep], "q_max": c_qmax[keep],
        "d_min": c_dmin[keep], "d_max": c_dmax[keep],
    }


def build_extension_specs(
    chains: dict,
    gene_index: GeneIndex,
    contig_index: ContigIndex,
    params: MapperParams,
    flat_base: int,
) -> dict | None:
    r"""Scalar-only extension specs for the device-side problem build.

    Same projection math as :func:`build_extension_problems`, but no code
    gathering happens on host — the per-pair query/target matrices are
    materialised on device by :func:`_ext_gather_bucket` from the resident
    gene-code table and the scan's padded genome streams.  ``flat_base`` is
    the genome's row offset into the flattened (B * L_pad) code stream.
    """
    n = len(chains["gene"])
    if n == 0:
        return None
    k = gene_index.k
    glen = gene_index.lengths[chains["gene"]]
    clen = contig_index.lengths[chains["ctg"]]
    t_lo = np.maximum(chains["t_min"] - chains["q_min"] - params.window_pad, 0)
    t_hi = np.minimum(
        chains["t_max"] + k + (glen - chains["q_max"] - k) + params.window_pad, clen
    )
    t_len = (t_hi - t_lo).astype(np.int64)
    d_mid = (chains["d_min"] + chains["d_max"]) // 2
    offsets = -(d_mid - t_lo)
    k_locals = (chains["d_max"] - chains["d_min"]) // 2 + params.band_slack
    from kaptive_tpu.ops.rowscan import PAD_POS

    t_flat = flat_base + PAD_POS + contig_index.starts[chains["ctg"]] + t_lo
    return dict(
        gene=chains["gene"], strand=chains["strand"],
        q_start=gene_index.starts[chains["gene"]].astype(np.int64),
        glen=glen.astype(np.int64), t_flat=t_flat.astype(np.int64),
        t_len=t_len, offsets=offsets.astype(np.int64),
        k_locals=k_locals.astype(np.int64), t_lo=t_lo,
    )


@functools.partial(
    jax.jit, static_argnames=("rows_max", "t_cols", "t_pad")
)
def _ext_gather_bucket(
    gene_codes, flat_codes, q_start, glen, strand, t_flat, t_len,
    *, rows_max: int, t_cols: int, t_pad: int,
):
    r"""Materialise one DP bucket's (query, target) matrices on device.

    Replaces the host matrix build + its per-bucket H2D upload.
    """
    j = jnp.arange(rows_max, dtype=jnp.int32)[None, :]
    fwd = (strand > 0)[:, None]
    qi = jnp.where(fwd, q_start[:, None] + j, q_start[:, None] + glen[:, None] - 1 - j)
    q = gene_codes[jnp.clip(qi, 0, gene_codes.shape[0] - 1)].astype(jnp.int32)
    q = jnp.where(fwd | (q >= 4), q, 3 - q)
    q = jnp.where(j < glen[:, None], q, 0).astype(jnp.uint8)
    jt = jnp.arange(t_cols, dtype=jnp.int32)[None, :]
    ti = jnp.clip(t_flat[:, None] + (jt - t_pad), 0, flat_codes.shape[0] - 1)
    t = flat_codes[ti].astype(jnp.uint8)
    t = jnp.where((jt >= t_pad) & (jt < t_pad + t_len[:, None]), t, 0)
    return q, t


def run_extension_dp_device(
    specs: dict, gene_index: GeneIndex, flat_codes, params: MapperParams
):
    r"""Bucketed banded-SWG sweep with device-side problem materialisation.

    Convenience wrapper: :func:`launch_extension_dp_device` +
    :func:`collect_extension_dp_device` (the streaming mapper keeps them
    separate so one chunk's DP executes while the next chunk's chains pull).
    """
    return collect_extension_dp_device(
        launch_extension_dp_device(specs, gene_index, flat_codes, params)
    )


def launch_extension_dp_device(
    specs: dict, gene_index: GeneIndex, flat_codes, params: MapperParams
):
    r"""Dispatch the bucketed banded-SWG sweep with device-side problem
    materialisation; returns a pending handle for
    :func:`collect_extension_dp_device`.

    ``specs`` is the merged output of :func:`build_extension_specs`;
    ``flat_codes`` the flattened (B * L_pad,) padded code stream from the
    scan stage (device-resident).  Bucket-shape policy matches
    :func:`kaptive_tpu.core.pairwise.batched_swg_align`.

    With ``params.emit_cigars`` the traceback additionally records BAM CIGAR
    runs (collect returns ``(PairwiseAlignments, Cigars)``; pairs whose op
    count overflowed the device buffer get an empty CIGAR, stats stay exact)
    — the problem build stays fully device-resident either way.
    """
    from kaptive_tpu.core.pairwise import _stack_result
    from kaptive_tpu.ops.swg import banded_swg, banded_swg_lax_cigars, plan_swg_buckets

    n = len(specs["gene"])
    w_needed = 2 * specs["k_locals"] + 3
    joint = np.maximum(np.maximum(specs["glen"], specs["t_len"]), 1)

    gene_codes_d = gene_index.device_codes
    emit = bool(params.emit_cigars)
    launched = []
    for sel, rows_max, w_pad, b_pad in plan_swg_buckets(joint, w_needed, params.lattice):
        t_max = rows_max
        t_pad = w_pad + 2
        b = len(sel)

        def pad(x, fill=0):
            o = np.full(b_pad, fill, dtype=np.int32)
            o[:b] = x[sel]
            return o

        q_start = pad(specs["q_start"])
        glen = pad(specs["glen"], 1)
        strand = pad(specs["strand"], 1)
        t_flat = pad(specs["t_flat"])
        t_len = pad(specs["t_len"])
        q_mat, t_mat = _ext_gather_bucket(
            gene_codes_d, flat_codes,
            jnp.asarray(q_start), jnp.asarray(glen), jnp.asarray(strand),
            jnp.asarray(t_flat), jnp.asarray(t_len),
            rows_max=rows_max, t_cols=t_max + 2 * t_pad, t_pad=t_pad,
        )
        args = (
            q_mat, jnp.asarray(glen), t_mat, jnp.asarray(t_len),
            jnp.asarray(pad(specs["offsets"])), jnp.asarray(pad(specs["k_locals"], 1)),
        )
        statics = dict(
            gap_open=NT_GAP_OPEN, gap_extend=NT_GAP_EXTEND,
            rows_max=rows_max, w_pad=w_pad, t_pad=t_pad,
        )
        if emit:
            res, ops, n_ops, overflow = banded_swg_lax_cigars(
                *args, jnp.asarray(_NT_MATRIX), **statics
            )
            launched.append((sel, b, _stack_result(tuple(res)), (ops, n_ops, overflow)))
        else:
            res = banded_swg(*args, _NT_MATRIX, **statics)
            launched.append((sel, b, _stack_result(tuple(res)), None))
    return launched, n, emit


def collect_extension_dp_device(pending):
    r"""Pull a :func:`launch_extension_dp_device` dispatch back to host."""
    from kaptive_tpu.core.pairwise import _RESULT_FIELDS, PairwiseAlignments
    from kaptive_tpu.ops.swg import MAX_CIGAR_OPS

    launched, n, emit = pending
    out = {f: np.zeros(n, dtype=np.int32) for f in _RESULT_FIELDS}
    ops_out = np.zeros((n, MAX_CIGAR_OPS), dtype=np.uint32) if emit else None
    n_ops_out = np.zeros(n, dtype=np.int32) if emit else None
    for sel, b, stacked, cig in launched:
        arr = np.asarray(stacked)
        for i, field in enumerate(_RESULT_FIELDS):
            out[field][sel] = arr[i, :b]
        if cig is not None:
            ops, n_ops, overflow = cig
            ops_out[sel] = np.asarray(ops)[:b]
            n_ops_out[sel] = np.where(
                np.asarray(overflow)[:b], 0, np.asarray(n_ops)[:b]
            )
    res_out = PairwiseAlignments(*(out[f] for f in _RESULT_FIELDS))
    if not emit:
        return res_out
    from kaptive_tpu.core.alignment import Cigars
    from kaptive_tpu.core.collections import cumulative_offsets

    lengths = n_ops_out.astype(np.int32)
    offsets = cumulative_offsets(lengths)
    flat = (
        np.concatenate([ops_out[i, : lengths[i]] for i in range(n)])
        if n and lengths.sum()
        else np.empty(0, dtype=np.uint32)
    )
    return res_out, Cigars(flat.astype(np.uint32), offsets, lengths)


def build_extension_problems(
    chains: dict,
    gene_index: GeneIndex,
    contig_index: ContigIndex,
    params: MapperParams,
) -> dict | None:
    r"""Project chains to ragged banded-DP problems (host array assembly only)."""
    n = len(chains["gene"])
    if n == 0:
        return None

    k = gene_index.k
    glen = gene_index.lengths[chains["gene"]]
    clen = contig_index.lengths[chains["ctg"]]

    # Project the full gene onto the contig along the chain diagonals.
    t_lo = np.maximum(chains["t_min"] - chains["q_min"] - params.window_pad, 0)
    t_hi = np.minimum(
        chains["t_max"] + k + (glen - chains["q_max"] - k) + params.window_pad, clen
    )
    t_len = (t_hi - t_lo).astype(np.int64)

    # Band geometry in DP coordinates (q_pos - window_t_pos).
    d_mid = (chains["d_min"] + chains["d_max"]) // 2
    offsets = -(d_mid - t_lo)  # kernel offset convention: q_pos - t_pos
    k_locals = (chains["d_max"] - chains["d_min"]) // 2 + params.band_slack

    # Build ragged query (gene codes, revcomp for minus chains) and target windows.
    q_starts = gene_index.starts[chains["gene"]]
    fwd = chains["strand"] > 0
    base = np.where(fwd, q_starts, q_starts + glen - 1)
    steps = np.where(fwd, 1, -1)
    flat_idx, q_offsets, q_lengths = ragged_gather_indices(base, glen, steps)
    q_codes = gene_index.codes[flat_idx].astype(np.uint8)
    comp = np.repeat(~fwd, q_lengths)
    q_codes = np.where(comp & (q_codes < 4), 3 - q_codes, q_codes).astype(np.uint8)

    t_base = contig_index.starts[chains["ctg"]] + t_lo
    t_flat_idx, t_offsets, t_lengths = ragged_gather_indices(t_base, t_len)
    t_codes = contig_index.codes[t_flat_idx].astype(np.uint8)

    return dict(
        q_codes=q_codes, q_offsets=q_offsets, q_lengths=q_lengths.astype(np.int32),
        t_codes=t_codes, t_offsets=t_offsets, t_lengths=t_lengths.astype(np.int32),
        offsets=offsets.astype(np.int32), k_locals=k_locals.astype(np.int32),
        t_lo=t_lo, glen=glen,
    )


def _run_extension_dp(problems: dict, emit_cigars: bool = False, mesh=None, lattice=None):
    r"""One batched banded-SWG dispatch over concatenated extension problems.

    With ``emit_cigars`` the result gains a ``cigars`` attribute: a
    :class:`~kaptive_tpu.core.alignment.Cigars` batch aligned with the pairs
    (empty for pairs whose op count overflowed the device buffer).
    """
    if emit_cigars:
        from kaptive_tpu.core.pairwise import batched_swg_align_cigars

        return batched_swg_align_cigars(
            problems["q_codes"], problems["q_offsets"], problems["q_lengths"],
            problems["t_codes"], problems["t_offsets"], problems["t_lengths"],
            problems["offsets"], problems["k_locals"],
            matrix=_NT_MATRIX, gap_open=NT_GAP_OPEN, gap_extend=NT_GAP_EXTEND,
        )
    from kaptive_tpu.core.pairwise import batched_swg_align

    return batched_swg_align(
        problems["q_codes"], problems["q_offsets"], problems["q_lengths"],
        problems["t_codes"], problems["t_offsets"], problems["t_lengths"],
        problems["offsets"], problems["k_locals"],
        matrix=_NT_MATRIX, gap_open=NT_GAP_OPEN, gap_extend=NT_GAP_EXTEND,
        mesh=mesh, lattice=lattice,
    )


def _alignments_from_extension(
    chains: dict,
    res,
    t_lo: np.ndarray,
    glen: np.ndarray,
    gene_index: GeneIndex,
    genome: GenomeAssembly,
    contig_index: ContigIndex,
    gene_names: tuple[str, ...],
    params: MapperParams,
    cigars=None,
) -> Alignments:
    r"""Filter/dedupe DP results and assemble the SoA alignment batch."""
    keep = np.asarray(res.scores) >= params.min_score
    keep &= np.asarray(res.q_ends) > np.asarray(res.q_starts)
    if not keep.any():
        return Alignments.empty()

    gene = chains["gene"][keep]
    ctg = chains["ctg"][keep]
    strand = chains["strand"][keep]
    gl = glen[keep]
    scores = np.asarray(res.scores)[keep]
    matches = np.asarray(res.matches)[keep]
    mismatches = np.asarray(res.mismatches)[keep]
    gaps = np.asarray(res.gaps)[keep]
    qs_dp = np.asarray(res.q_starts)[keep].astype(np.int64)
    qe_dp = np.asarray(res.q_ends)[keep].astype(np.int64)
    ts_dp = np.asarray(res.t_starts)[keep].astype(np.int64)
    te_dp = np.asarray(res.t_ends)[keep].astype(np.int64)
    t_lo_k = t_lo[keep]

    # Map DP coordinates back: minus-strand queries were reverse-complemented.
    fwd = strand > 0
    q_start = np.where(fwd, qs_dp, gl - qe_dp)
    q_end = np.where(fwd, qe_dp, gl - qs_dp)
    t_start = t_lo_k + ts_dp
    t_end = t_lo_k + te_dp

    # Deduplicate identical (gene, ctg, strand, t interval) hits, keeping best score.
    dedup_key = np.lexsort((-scores, t_end, t_start, strand, ctg, gene))
    gk, ck, sk = gene[dedup_key], ctg[dedup_key], strand[dedup_key]
    tsk, tek = t_start[dedup_key], t_end[dedup_key]
    uniq = np.empty(len(dedup_key), dtype=bool)
    uniq[0] = True
    uniq[1:] = (
        (gk[1:] != gk[:-1]) | (ck[1:] != ck[:-1]) | (sk[1:] != sk[:-1])
        | (tsk[1:] != tsk[:-1]) | (tek[1:] != tek[:-1])
    )
    sel = np.sort(dedup_key[uniq])

    gene, ctg, strand = gene[sel], ctg[sel], strand[sel]
    scores, matches, mismatches, gaps = scores[sel], matches[sel], mismatches[sel], gaps[sel]
    q_start, q_end, t_start, t_end = q_start[sel], q_end[sel], t_start[sel], t_end[sel]
    gl = gl[sel]
    kept_cigars = None
    if cigars is not None:
        kept_rows = np.flatnonzero(keep)[sel]
        kept_cigars = cigars[kept_rows]

    # Primary flag + mapq: per gene, the top-scoring hit is primary; mapq
    # follows the minimap2 convention (``mm_set_mapq``):
    #   mapq = 60 * (1 - s2/s1) * min(1, s1/100), clipped to [0, 60]
    # where s1 is the primary score and s2 the runner-up for the same query;
    # secondaries report 0.  (A plain 60*(1-ratio) heuristic would lack the
    # low-score penalty term.)
    n = len(gene)
    order = np.lexsort((-scores, gene))
    is_primary = np.zeros(n, dtype=bool)
    first = np.empty(len(order), dtype=bool)
    first[0] = True
    first[1:] = gene[order][1:] != gene[order][:-1]
    is_primary[order[first]] = True
    best_per_gene = np.zeros(int(gene.max()) + 1, dtype=np.int64)
    second_per_gene = np.zeros(int(gene.max()) + 1, dtype=np.int64)
    np.maximum.at(best_per_gene, gene, scores)
    not_best = scores < best_per_gene[gene]
    np.maximum.at(second_per_gene, gene[not_best], scores[not_best])
    # An exact tie for best (repeat gene copies) means the runner-up margin is
    # zero: count best-score hits per gene and treat >1 as runner-up == best,
    # so tied placements report mapq ~0 instead of maximum confidence.
    n_best = np.zeros(int(gene.max()) + 1, dtype=np.int64)
    np.add.at(n_best, gene[~not_best], 1)
    second_per_gene = np.where(n_best > 1, best_per_gene, second_per_gene)
    s1 = best_per_gene[gene].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        margin = np.where(s1 > 0, 1.0 - second_per_gene[gene] / np.maximum(s1, 1), 0.0)
    low_score_pen = np.minimum(1.0, s1 / 100.0)
    mapq = np.where(
        is_primary, np.clip(np.rint(60.0 * margin * low_score_pen), 0, 60), 0
    ).astype(np.uint8)

    edit_distance = mismatches + gaps
    # Gap-expanded per-base divergence over the aligned block (the analog of
    # minimap2's ``de`` tag the reference ingests at ``alignment.py:409-446``;
    # ``de`` proper is gap-compressed — this counts each gapped column, so it
    # upper-bounds ``de`` and equals it for gapless hits).
    aligned_cols = matches + mismatches + gaps
    with np.errstate(divide="ignore", invalid="ignore"):
        divergence = np.where(
            aligned_cols > 0, (mismatches + gaps) / np.maximum(aligned_cols, 1), 0.0
        )
    return Alignments.from_arrays(
        q_name_ids=gene.astype(np.int32),
        q_names_dict=gene_names,
        q_lengths=gl.astype(np.int32),
        q_starts=q_start.astype(np.int32),
        q_ends=q_end.astype(np.int32),
        t_name_ids=ctg.astype(np.int32),
        t_names_dict=genome.contigs.ids,
        t_lengths=contig_index.lengths[ctg].astype(np.int32),
        t_starts=t_start.astype(np.int32),
        t_ends=t_end.astype(np.int32),
        strands=strand.astype(np.int8),
        matches=matches,
        edit_distances=edit_distance,
        scores=scores,
        qualities=mapq,
        block_lengths=np.maximum(q_end - q_start, t_end - t_start).astype(np.int32),
        cigars=kept_cigars,
        is_primary=is_primary,
        divergence=divergence,
    )


def map_genes(
    gene_index: GeneIndex,
    genome: GenomeAssembly,
    gene_names: tuple[str, ...],
    params: MapperParams | None = None,
) -> Alignments:
    r"""Map every DB gene against the assembly's contigs (dense all-hits mode).

    Returns an :class:`Alignments` batch with q_names = gene indices as strings
    (matching the reference's convention of stringified DB gene indices,
    ``serotyping/core.py:111-122``) and t_names = contig names.
    """
    return map_genes_batch(gene_index, [genome], gene_names, params)[0]


def _map_genes_host_seeded(
    gene_index: GeneIndex, genomes: list, indexes: list,
    gene_names: tuple[str, ...], params: MapperParams,
) -> list[Alignments]:
    r"""Host-seeded mapping: C scan+match + host chaining, device DP sweeps.

    The seed/chain halves run on the host (typically pre-computed by the
    ingest pool — ``ci._cache["host_chains"]`` — so they fully overlap the
    previous batch's device compute), and the device spends its cycles on the
    banded-SWG extension sweep alone.  Versus the device-scan path this
    removes the scan/match/chain stages (~0.46 s of serialized-gather-bound
    device time per 16-genome batch) and shrinks the per-genome H2D from the
    1.33 MB packed stream to the ~60 KB of DP problem windows.  Anchor sets
    are bit-identical between the two modes (``tests/test_host_seed.py``).
    """
    from kaptive_tpu.core.pairwise import PairwiseAlignments
    from kaptive_tpu.utils.metrics import count as _count
    from kaptive_tpu.utils.profiling import phase_timer

    n_genomes = len(genomes)
    with phase_timer("map.host_seed"):
        all_chains: list[dict | None] = []
        for ci in indexes:
            # Pre-seeded entries are keyed by (gene_index, params): a
            # ContigIndex reused against a different database or tunables
            # must re-seed, not consume chains whose gene rows point into
            # another table.
            cached = ci._cache.get("host_chains")
            chains = None
            if cached is not None:
                seed_gi, seed_params, seed_chains = cached
                if seed_gi is gene_index and seed_params == params:
                    chains = seed_chains
                    _count("map.host_seed.preseeded")
            if chains is None:
                chains = host_seed_chains(gene_index, ci, params)
            all_chains.append(chains if chains and len(chains["gene"]) else None)
    with phase_timer("map.chain_host"):
        all_problems = [
            build_extension_problems(ch, gene_index, ci, params) if ch is not None else None
            for ch, ci in zip(all_chains, indexes)
        ]
    live = [p for p in all_problems if p is not None]
    if not live:
        return [Alignments.empty() for _ in range(n_genomes)]
    merged = dict(
        q_codes=np.concatenate([p["q_codes"] for p in live]),
        q_lengths=np.concatenate([p["q_lengths"] for p in live]).astype(np.int32),
        t_codes=np.concatenate([p["t_codes"] for p in live]),
        t_lengths=np.concatenate([p["t_lengths"] for p in live]).astype(np.int32),
        offsets=np.concatenate([p["offsets"] for p in live]).astype(np.int32),
        k_locals=np.concatenate([p["k_locals"] for p in live]).astype(np.int32),
    )
    from kaptive_tpu.core.collections import cumulative_offsets

    merged["q_offsets"] = cumulative_offsets(merged["q_lengths"])
    merged["t_offsets"] = cumulative_offsets(merged["t_lengths"])
    with phase_timer("map.extension_dp"):
        cigars_all = None
        if params.emit_cigars:
            res, cigars_all = _run_extension_dp(merged, emit_cigars=True)
        else:
            res = _run_extension_dp(merged, lattice=params.lattice)
    counts = [len(p["q_lengths"]) if p is not None else 0 for p in all_problems]
    bounds = np.cumsum([0] + counts)
    results: list[Alignments] = []
    for b in range(n_genomes):
        if all_problems[b] is None:
            results.append(Alignments.empty())
            continue
        sl = slice(bounds[b], bounds[b + 1])
        res_b = PairwiseAlignments(
            res.scores[sl], res.matches[sl], res.mismatches[sl], res.gaps[sl],
            res.q_starts[sl], res.q_ends[sl], res.t_starts[sl], res.t_ends[sl],
        )
        results.append(
            _alignments_from_extension(
                all_chains[b], res_b, all_problems[b]["t_lo"], all_problems[b]["glen"],
                gene_index, genomes[b], indexes[b], gene_names, params,
                cigars=cigars_all[sl] if cigars_all is not None else None,
            )
        )
    return results


def map_genes_batch(
    gene_index: GeneIndex,
    genomes: list,
    gene_names: tuple[str, ...],
    params: MapperParams | None = None,
    mesh=None,
    seed_mode: str | None = None,
) -> list[Alignments]:
    r"""Map the DB gene set against a batch of assemblies with amortised dispatches.

    The per-assembly device work (seeding scan + table match) runs as ONE
    vmapped dispatch over the batch, and the banded extensions of every chain
    from every assembly run as one bucketed DP sweep — dispatch and transfer
    latency is paid once per batch, not per genome.

    With a multi-device ``mesh``, the seeding stages shard assemblies over the
    ``data`` axis and the gene table over the ``model`` axis (anchor sets
    merged with an all_gather), and the DP sweeps shard their pair axis over
    every device — see :mod:`kaptive_tpu.parallel.typing`.
    """
    from kaptive_tpu.utils.profiling import phase_timer

    params = params or MapperParams()
    indexes = [g.get_minimizer_index() for g in genomes]
    n_genomes = len(genomes)
    if n_genomes == 0:
        return []
    if len(gene_index.minimizers.hashes) == 0:  # empty DB gene table
        return [Alignments.empty() for _ in range(n_genomes)]

    # Device upload of the code streams.  Preferred form is SPARSE — the
    # quantised real-prefix 2-bit stream plus an exception list, ~2.4x fewer
    # H2D bytes than the dense (bucket-padded stream + validity bitmask)
    # form — and the ingest threads pre-upload + block so the transfer of the
    # NEXT batch overlaps the current batch's compute.
    single_dev = mesh is None or int(mesh.devices.size) <= 1
    if single_dev and resolve_seed_mode(seed_mode) == "host":
        return _map_genes_host_seeded(gene_index, genomes, indexes, gene_names, params)
    with phase_timer("map.pack_upload"):
        from kaptive_tpu.utils.metrics import count as _count

        L = max(int(ci.codes.shape[0]) for ci in indexes)
        # Per-genome sparse device uploads (usually already resident: ingest
        # threads pre-upload and block on the transfer).  A genome beyond
        # EXC_CAP exceptions falls back to the dense form for ITS chunk only.
        sparse_rows = (
            [_device_inputs_sparse(ci) for ci in indexes] if single_dev else None
        )

    cap_mins = max(L // MIN_DENSITY_CAP, 1024)
    cap_anchors = ANCHOR_CAP
    flat_codes = None  # device-resident padded code stream (single-device path)
    if mesh is not None and int(mesh.devices.size) > 1:
        from kaptive_tpu.parallel.typing import ShardedGeneTable, sharded_scan_match_chain

        data_axis = int(mesh.shape.get("data", 1))
        model_axis = int(mesh.shape.get("model", 1))
        key = ("sharded_table", model_axis)
        if key not in gene_index._cache:
            gene_index._cache[key] = ShardedGeneTable.build(gene_index, model_axis)
        pad_to = -(-n_genomes // data_axis) * data_axis
        packed = np.zeros((pad_to, L // 4), dtype=np.uint8)
        bits = np.zeros((pad_to, L // 8), dtype=np.uint8)
        for b, ci in enumerate(indexes):  # pad rows: no valid bases -> no anchors
            pb, vb, _ = _packed_inputs(ci)
            packed[b, : len(pb)] = pb
            bits[b, : len(vb)] = vb
        # Floor of 32 keeps the chain program's shape stable across contig
        # counts up to 32 (draft assemblies routinely have dozens of contigs;
        # every distinct width is a fresh compile).
        c_pad = 32
        while c_pad < max(len(ci.starts) for ci in indexes):
            c_pad *= 2
        starts_pad = np.full((pad_to, c_pad), np.int32(0x7FFFFFFF), np.int32)
        for b, ci in enumerate(indexes):
            starts_pad[b, : len(ci.starts)] = ci.starts.astype(np.int32)
        with phase_timer("map.scan_match"):
            chains_np, counts = sharded_scan_match_chain(
                mesh, packed, bits, gene_index._cache[key],
                starts_pad, gene_index.lengths.astype(np.int32),
                length=L, cap_mins=cap_mins, cap_anchors=cap_anchors,
                max_occ=min(params.max_occ, DEVICE_MAX_OCC),
                k=gene_index.k, w=gene_index.w,
                cap_chains=CHAIN_CAP,
                max_diag_drift=params.max_diag_drift,
                max_anchor_gap=params.max_anchor_gap,
                min_anchors=params.min_anchors,
            )
            chains_np = chains_np[:n_genomes]
            out = {key2: v[:n_genomes] for key2, v in counts.items()}
            # Per-shard caps are enforced independently; row_overflow does not
            # exist on this (non-rowcompact) path, but the compact-scan's
            # cap_mins truncation does — flag it so the host fallback fires.
            out["row_overflow"] = np.zeros(n_genomes, dtype=np.int32)
            out["mins_capped"] = (out["n_minimizers"] > cap_mins).astype(np.int32)
    else:
        th, tg, tp, ts = gene_index.device_table
        bs, rl, iters = gene_index.device_lookup
        with phase_timer("map.scan_match"):
            # The device stages run in fixed SCAN_CHUNK-genome slices so the
            # compiled-program set is independent of the streaming batch size
            # (every distinct batch shape used to cost a fresh scan/match/
            # chain compile).  All chunks are
            # dispatched before any result is pulled back, so their
            # executions and D2H transfers overlap.
            c_pad = 32  # shape-stable up to 32 contigs (see the mesh path)
            while c_pad < max(len(ci.starts) for ci in indexes):
                c_pad *= 2
            starts_pad = np.full((n_genomes, c_pad), np.int32(0x7FFFFFFF), np.int32)
            for b, ci in enumerate(indexes):
                starts_pad[b, : len(ci.starts)] = ci.starts.astype(np.int32)
            live_sparse = [s for s in sparse_rows if s is not None]
            if live_sparse:
                w4 = max(int(s[0].shape[0]) for s in live_sparse)
                e_q = max(int(s[1].shape[0]) for s in live_sparse)
            launched_chunks = []
            for c0 in range(0, n_genomes, SCAN_CHUNK):
                hi = min(c0 + SCAN_CHUNK, n_genomes)
                sc = jnp.asarray(starts_pad[c0:hi])
                if hi - c0 < SCAN_CHUNK:  # pad rows: no valid bases -> no anchors
                    pad_n = SCAN_CHUNK - (hi - c0)
                    sc = jnp.pad(sc, ((0, pad_n), (0, 0)), constant_values=0x7FFFFFFF)
                if all(sparse_rows[i] is not None for i in range(c0, hi)):
                    chunk_p, chunk_e, chunk_r = [], [], []
                    for i in range(c0, c0 + SCAN_CHUNK):
                        if i < hi:
                            p, e, r = sparse_rows[i]
                            if int(p.shape[0]) < w4:
                                p = jnp.pad(p, (0, w4 - int(p.shape[0])))
                            if int(e.shape[0]) < e_q:
                                e = jnp.pad(
                                    e, (0, e_q - int(e.shape[0])),
                                    constant_values=0x40000000,
                                )
                            chunk_p.append(p)
                            chunk_e.append(e)
                            chunk_r.append(int(r))
                        else:  # pad genome: zero real length -> all sentinels
                            chunk_p.append(jnp.zeros(w4, dtype=jnp.uint8))
                            chunk_e.append(
                                jnp.full(e_q, 0x40000000, dtype=jnp.int32)
                            )
                            chunk_r.append(0)
                    padded, flat_c = _unpack_batch_sparse(
                        jnp.stack(chunk_p), jnp.stack(chunk_e),
                        jnp.asarray(chunk_r, dtype=jnp.int32), length=L,
                    )
                    rows_h, rows_a, rows_c = rowcompact_scan_xla(
                        padded, gene_index.k, gene_index.w
                    )
                else:
                    _count("map.dense_upload", hi - c0)
                    rows_p, rows_b = [], []
                    for i in range(c0, c0 + SCAN_CHUNK):
                        if i < hi:
                            dp, db_ = _device_inputs(indexes[i])
                            if int(dp.shape[0]) < L // 4:
                                dp = jnp.pad(dp, (0, L // 4 - int(dp.shape[0])))
                                db_ = jnp.pad(db_, (0, L // 8 - int(db_.shape[0])))
                        else:
                            dp = jnp.zeros(L // 4, dtype=jnp.uint8)
                            db_ = jnp.zeros(L // 8, dtype=jnp.uint8)
                        rows_p.append(dp)
                        rows_b.append(db_)
                    rows_h, rows_a, rows_c, flat_c = _rowcompact_batch(
                        jnp.stack(rows_p), jnp.stack(rows_b),
                        length=L, k=gene_index.k, w=gene_index.w,
                    )
                anchors_d, counts_d = _match_rows_batch(
                    rows_h, rows_a, rows_c, th, tg, tp, ts, bs, rl,
                    gene_index.device_bloom,
                    CANDIDATE_CAP, cap_anchors, iters,
                    min(params.max_occ, DEVICE_MAX_OCC),
                )
                # Chain on device: the 64K-anchor buffers stay resident and
                # only ~CHAIN_CAP chain descriptors per genome reach the
                # host (~1.3 MB instead of up to 12 MB of raw anchors).
                chains_d, counts2_d = _chain_batch(
                    anchors_d, counts_d, sc,
                    gene_index.device_gene_lengths,
                    gene_index.k, CHAIN_CAP,
                    params.max_diag_drift, params.max_anchor_gap,
                    params.min_anchors,
                )
                launched_chunks.append((chains_d, counts2_d, flat_c))
        # Per-chunk interleave: pull chunk c's chains and build+dispatch its
        # extension DP while chunk c+1's scan still executes on device — the
        # host work and DP dispatch hide inside the next chunk's queue time
        # instead of adding a full work-queue re-entry per phase.
        return _finish_chunks_device(
            launched_chunks, indexes, genomes, gene_index, gene_names, params,
            n_genomes, L,
        )

    # --- sharded-mesh tail: chains were pulled for the whole batch ----------
    # Per-genome host phases: chains -> extension problem specs; the DP
    # sweep runs sharded over the mesh from host-built problems.
    use_device_dp = flat_codes is not None
    from kaptive_tpu.ops.rowscan import PAD_POS

    lp = L + 2 * PAD_POS  # per-genome length within the flattened padded stream
    all_chains: list[dict | None] = []
    all_problems: list[dict | None] = []
    chain_timer = phase_timer("map.chain_host")
    chain_timer.__enter__()
    from kaptive_tpu.utils.metrics import count as _count

    for b, ci in enumerate(indexes):
        causes = {
            "row_overflow": int(out["row_overflow"][b]) > 0,
            # mesh path only: the compact scan truncates at cap_mins (the
            # rowcompact path has per-row capacity, covered by row_overflow)
            "minimizers": "mins_capped" in out and int(out["mins_capped"][b]) > 0,
            "candidates": int(out["n_candidates"][b]) > CANDIDATE_CAP,
            "anchors": int(out["n_anchors"][b]) > cap_anchors,
            "chains": int(out["n_chains"][b]) > CHAIN_CAP,
        }
        overflow = any(causes.values())
        if overflow:
            for cause, hit in causes.items():
                if hit:
                    _count(f"map.host_fallback.{cause}")
            _count("map.host_chained")
            anchors = find_anchors(gene_index, ci.minimizers, params)
            chains = chain_anchors(*anchors, gene_index.lengths, gene_index.k, params)
        else:
            _count("map.device_chained")
            arr = chains_np[b].astype(np.int64)
            n_ch = int(out["n_kept"][b])  # device-compacted >= min_anchors prefix
            chains = {f: arr[i][:n_ch] for i, f in enumerate(_CHAIN_FIELDS)}
        if not chains or len(chains["gene"]) == 0:
            all_chains.append(None)
            all_problems.append(None)
            continue
        all_chains.append(chains)
        if use_device_dp:
            all_problems.append(
                build_extension_specs(chains, gene_index, ci, params, flat_base=b * lp)
            )
        else:
            all_problems.append(build_extension_problems(chains, gene_index, ci, params))
    chain_timer.__exit__(None, None, None)

    # One DP sweep over every chain of every genome.
    live = [p for p in all_problems if p is not None]
    results: list[Alignments] = []
    if live:
        if use_device_dp:
            merged = {
                key2: np.concatenate([p[key2] for p in live])
                for key2 in live[0]
                if key2 not in ("t_lo",)
            }
            with phase_timer("map.extension_dp"):
                cigars_all = None
                res = run_extension_dp_device(merged, gene_index, flat_codes, params)
                if params.emit_cigars:
                    res, cigars_all = res
            counts = [len(p["glen"]) if p is not None else 0 for p in all_problems]
        else:
            merged = dict(
                q_codes=np.concatenate([p["q_codes"] for p in live]),
                q_lengths=np.concatenate([p["q_lengths"] for p in live]).astype(np.int32),
                t_codes=np.concatenate([p["t_codes"] for p in live]),
                t_lengths=np.concatenate([p["t_lengths"] for p in live]).astype(np.int32),
                offsets=np.concatenate([p["offsets"] for p in live]).astype(np.int32),
                k_locals=np.concatenate([p["k_locals"] for p in live]).astype(np.int32),
            )
            from kaptive_tpu.core.collections import cumulative_offsets

            merged["q_offsets"] = cumulative_offsets(merged["q_lengths"])
            merged["t_offsets"] = cumulative_offsets(merged["t_lengths"])
            with phase_timer("map.extension_dp"):
                cigars_all = None
                if params.emit_cigars:
                    res, cigars_all = _run_extension_dp(merged, emit_cigars=True)
                else:
                    res = _run_extension_dp(merged, mesh=mesh, lattice=params.lattice)
            counts = [len(p["q_lengths"]) if p is not None else 0 for p in all_problems]
        # Split DP results back per genome.
        bounds = np.cumsum([0] + counts)
        from kaptive_tpu.core.pairwise import PairwiseAlignments

        for b in range(n_genomes):
            if all_problems[b] is None:
                results.append(Alignments.empty())
                continue
            sl = slice(bounds[b], bounds[b + 1])
            res_b = PairwiseAlignments(
                res.scores[sl], res.matches[sl], res.mismatches[sl], res.gaps[sl],
                res.q_starts[sl], res.q_ends[sl], res.t_starts[sl], res.t_ends[sl],
            )
            results.append(
                _alignments_from_extension(
                    all_chains[b], res_b, all_problems[b]["t_lo"], all_problems[b]["glen"],
                    gene_index, genomes[b], indexes[b], gene_names, params,
                    cigars=cigars_all[sl] if cigars_all is not None else None,
                )
            )
    else:
        results = [Alignments.empty() for _ in range(n_genomes)]
    return results


def _fetch_dp_pendings(dp_pendings: list):
    r"""ONE blocking ``device_get`` over every launched DP bucket of every
    pending; returns pendings with device arrays replaced by numpy so a later
    :func:`collect_extension_dp_device` never waits on the device.

    Every sync point costs a wait on the device's work queue, not per byte —
    fetching every chunk's buckets in one call pays that wait once.
    """
    leaves = []
    for p in dp_pendings:
        if p is None:
            continue
        launched, _, _ = p
        for _, _, stacked, cig in launched:
            leaves.append(stacked)
            if cig is not None:
                leaves.extend(cig)
    if not leaves:
        return dp_pendings
    vals = iter(jax.device_get(leaves))
    out = []
    for p in dp_pendings:
        if p is None:
            out.append(None)
            continue
        launched, n, emit = p
        new_launched = []
        for sel, b, _, cig in launched:
            stacked_np = next(vals)
            cig_np = tuple(next(vals) for _ in range(3)) if cig is not None else None
            new_launched.append((sel, b, stacked_np, cig_np))
        out.append((new_launched, n, emit))
    return out


def _finish_chunks_device(
    launched_chunks, indexes, genomes, gene_index: GeneIndex,
    gene_names, params: MapperParams, n_genomes: int, L: int,
) -> list[Alignments]:
    r"""Single-device tail of :func:`map_genes_batch`: one batched pull of
    every chunk's counts + chain prefixes (ONE sync for the whole batch),
    host chaining/spec-building per chunk, all extension-DP sweeps launched,
    then one bulk fetch of every DP bucket (a second single sync).
    """
    from kaptive_tpu.core.pairwise import PairwiseAlignments
    from kaptive_tpu.ops.rowscan import PAD_POS
    from kaptive_tpu.utils.metrics import count as _count
    from kaptive_tpu.utils.profiling import phase_timer

    lp = L + 2 * PAD_POS  # per-genome length within a chunk's flat stream
    # ONE batched D2H for every chunk's counts and chain-row prefixes: each
    # np.asarray sync costs a full work-queue wait, and a per-chunk protocol
    # would pay two per chunk.
    with phase_timer("map.scan_sync"):
        counts_all = jnp.stack([c for _, c, _ in launched_chunks])
        prefix_all = jnp.stack(
            [ch[:, :, :CHAIN_PREFIX] for ch, _, _ in launched_chunks]
        )
        counts_np_all, prefix_np_all = jax.device_get((counts_all, prefix_all))

    pendings = []
    for chunk_i, c0 in enumerate(range(0, n_genomes, SCAN_CHUNK)):
        chains_d, _, flat_c = launched_chunks[chunk_i]
        hi = min(c0 + SCAN_CHUNK, n_genomes)
        counts_np = counts_np_all[chunk_i]  # (6, SCAN_CHUNK)
        out_c = {k2: counts_np[i] for i, k2 in enumerate(_ROW_COUNT_FIELDS)}
        out_c["n_chains"] = counts_np[len(_ROW_COUNT_FIELDS)]
        out_c["n_kept"] = counts_np[len(_ROW_COUNT_FIELDS) + 1]
        # Kept (>= min_anchors, device-compacted) chain counts beyond the
        # prefix are rare — typical counts are O(100), CHAIN_PREFIX covers
        # 5x that; pull that chunk's full buffer then.
        n_ch_max = int(out_c["n_kept"][: hi - c0].max(initial=0))
        chains_pull = prefix_np_all[chunk_i]
        if n_ch_max > CHAIN_PREFIX:
            _count("map.chain_prefix_miss")
            with phase_timer("map.scan_sync"):
                chains_pull = np.asarray(chains_d)

        chunk_chains: list[dict | None] = []
        chunk_problems: list[dict | None] = []
        with phase_timer("map.chain_host"):
            for b_local in range(hi - c0):
                b = c0 + b_local
                ci = indexes[b]
                causes = {
                    "row_overflow": int(out_c["row_overflow"][b_local]) > 0,
                    "candidates": int(out_c["n_candidates"][b_local]) > CANDIDATE_CAP,
                    "anchors": int(out_c["n_anchors"][b_local]) > ANCHOR_CAP,
                    "chains": int(out_c["n_chains"][b_local]) > CHAIN_CAP,
                }
                if any(causes.values()):
                    for cause, hit in causes.items():
                        if hit:
                            _count(f"map.host_fallback.{cause}")
                    _count("map.host_chained")
                    anchors = find_anchors(gene_index, ci.minimizers, params)
                    chains = chain_anchors(
                        *anchors, gene_index.lengths, gene_index.k, params
                    )
                else:
                    _count("map.device_chained")
                    arr = chains_pull[b_local].astype(np.int64)
                    n_ch = int(out_c["n_kept"][b_local])  # device-compacted prefix
                    chains = {f: arr[i][:n_ch] for i, f in enumerate(_CHAIN_FIELDS)}
                if not chains or len(chains["gene"]) == 0:
                    chunk_chains.append(None)
                    chunk_problems.append(None)
                    continue
                chunk_chains.append(chains)
                chunk_problems.append(
                    build_extension_specs(
                        chains, gene_index, ci, params, flat_base=b_local * lp
                    )
                )

        live = [p for p in chunk_problems if p is not None]
        dp_pending = None
        if live:
            merged = {
                key: np.concatenate([p[key] for p in live])
                for key in live[0]
                if key != "t_lo"
            }
            with phase_timer("map.extension_dp"):
                dp_pending = launch_extension_dp_device(
                    merged, gene_index, flat_c, params
                )
        pendings.append((c0, hi, chunk_chains, chunk_problems, dp_pending))

    # Bulk-fetch every chunk's DP buckets with one blocking call, then the
    # per-chunk collection below is pure numpy bookkeeping.
    with phase_timer("map.extension_dp"):
        fetched = _fetch_dp_pendings([p[4] for p in pendings])

    results: list[Alignments] = []
    for (c0, hi, chunk_chains, chunk_problems, _), dp_pending in zip(pendings, fetched):
        if dp_pending is None:
            results.extend(Alignments.empty() for _ in range(hi - c0))
            continue
        resc = collect_extension_dp_device(dp_pending)
        cigars_all = None
        if params.emit_cigars:
            resc, cigars_all = resc
        counts_list = [
            len(p["glen"]) if p is not None else 0 for p in chunk_problems
        ]
        bounds = np.cumsum([0] + counts_list)
        for b_local in range(hi - c0):
            if chunk_problems[b_local] is None:
                results.append(Alignments.empty())
                continue
            sl = slice(bounds[b_local], bounds[b_local + 1])
            res_b = PairwiseAlignments(
                resc.scores[sl], resc.matches[sl], resc.mismatches[sl],
                resc.gaps[sl], resc.q_starts[sl], resc.q_ends[sl],
                resc.t_starts[sl], resc.t_ends[sl],
            )
            b = c0 + b_local
            results.append(
                _alignments_from_extension(
                    chunk_chains[b_local], res_b,
                    chunk_problems[b_local]["t_lo"], chunk_problems[b_local]["glen"],
                    gene_index, genomes[b], indexes[b], gene_names, params,
                    cigars=cigars_all[sl] if cigars_all is not None else None,
                )
            )
    return results
