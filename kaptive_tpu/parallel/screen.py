r"""Jittable locus screening: the fully on-device scoring phase of typing.

This is the whole-pipeline-jit realisation of the serotyper's scoring phase
(ref ``serotyping/core.py:164-207``) over a *batch of assemblies*: device
minimizer scan -> binary-search lookup in the (replicated or sharded) DB gene
minimizer table -> per-gene anchor tallies -> per-locus scores via a one-hot
matmul -> completeness-cubed weighting -> best-locus argmax.

Sharding contract (SURVEY.md §2.3): assemblies shard over the ``data`` mesh
axis; the gene minimizer table optionally shards by hash range over the
``model`` axis, in which case each device tallies only its table shard and
per-gene tallies merge with ``psum`` over ``model`` before locus scoring —
the merged result is bit-identical to the single-device computation (verified
in ``tests/test_parallel.py``).

The screen is used for (a) fast batch pre-classification (candidate locus
selection before full reconstruction), (b) the multi-chip scaling path, and
(c) the driver's compile checks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from kaptive_tpu.ops.minimizer import UINT32_MAX, minimizer_scan

MAX_OCC = 8  # per-minimizer occurrence cap inside the jitted screen


@dataclass(frozen=True)
class ScreenTables:
    r"""Device-ready DB arrays for the screen step (host-side container)."""

    table_hashes: np.ndarray  # (T,) uint32 sorted gene-minimizer hashes
    table_genes: np.ndarray  # (T,) int32 gene index per table entry
    gene_locus_onehot: np.ndarray  # (G, NL) f32, expected genes only
    expected_per_locus: np.ndarray  # (NL,) f32
    gene_minimizer_counts: np.ndarray  # (G,) f32 minimizers per gene (for coverage proxy)

    @classmethod
    def from_database(cls, db) -> "ScreenTables":
        gi = db.gene_index
        ms = gi.minimizers
        n_genes = len(db.genes)
        n_loci = len(db.loci)
        onehot = np.zeros((n_genes, n_loci), dtype=np.float32)
        expected = ~db.extra_genes
        onehot[np.arange(n_genes)[expected], db.gene_locus_indices[expected]] = 1.0
        counts = np.bincount(ms.seq_indices, minlength=n_genes).astype(np.float32)
        expected_per_locus = np.maximum(
            np.bincount(db.gene_locus_indices[expected], minlength=n_loci), 1
        ).astype(np.float32)
        return cls(
            ms.hashes.astype(np.uint32),
            ms.seq_indices.astype(np.int32),
            onehot,
            expected_per_locus,
            np.maximum(counts, 1.0),
        )


def _tally_one(codes, table_hashes, table_genes, n_genes: int):
    r"""Per-assembly gene tally: minimizer scan + capped table lookup + scatter-add."""
    sel, hashes, _ = minimizer_scan(codes)
    h = jnp.where(sel, hashes, UINT32_MAX)
    t_len = table_hashes.shape[0]
    lo = jnp.searchsorted(table_hashes, h)
    tally = jnp.zeros(n_genes + 1, dtype=jnp.float32)
    for o in range(MAX_OCC):
        in_bounds = lo + o < t_len  # clamping alone would re-count the last entry
        idx = jnp.minimum(lo + o, t_len - 1)
        match = in_bounds & (table_hashes[idx] == h) & sel
        g = jnp.where(match, table_genes[idx], n_genes)
        tally = tally.at[g].add(1.0)
    return tally[:n_genes]


@functools.partial(jax.jit, static_argnames=("n_genes",))
def locus_screen_batch(
    codes_batch: jax.Array,  # (B, L) uint8 encoded contig stream per assembly
    table_hashes: jax.Array,  # (T,) uint32 sorted
    table_genes: jax.Array,  # (T,) int32
    gene_locus_onehot: jax.Array,  # (G, NL) f32
    expected_per_locus: jax.Array,  # (NL,) f32
    gene_minimizer_counts: jax.Array,  # (G,) f32
    *,
    n_genes: int,
):
    r"""Single-device batched screen: best locus + weighted score per assembly."""
    tallies = jax.vmap(lambda c: _tally_one(c, table_hashes, table_genes, n_genes))(codes_batch)
    return _score_from_tallies(tallies, gene_locus_onehot, expected_per_locus, gene_minimizer_counts)


def _score_from_tallies(tallies, gene_locus_onehot, expected_per_locus, gene_minimizer_counts):
    # Per-gene pseudo-coverage: matched minimizers / gene minimizers, clipped.
    covs = jnp.clip(tallies / gene_minimizer_counts[None, :], 0.0, 1.0)
    # Locus score = sum of expected-gene coverages (one matmul), with the
    # reference's completeness^3 weighting (fraction of expected genes hit).
    locus_scores = jnp.dot(covs, gene_locus_onehot, preferred_element_type=jnp.float32)
    hit = (tallies > 0).astype(jnp.float32)
    locus_counts = jnp.dot(hit, gene_locus_onehot, preferred_element_type=jnp.float32)
    completeness = locus_counts / expected_per_locus[None, :]
    weighted = locus_scores * completeness**3
    best = jnp.argmax(weighted, axis=1).astype(jnp.int32)
    return best, weighted


def sharded_locus_screen(
    mesh: Mesh,
    codes_batch: np.ndarray,
    tables: ScreenTables,
):
    r"""shard_map'd screen: assemblies over ``data``, gene table over ``model``.

    Each device scans its assembly shard against its hash-range shard of the
    gene table; per-gene tallies are merged with ``psum`` over ``model`` before
    locus scoring, reproducing the single-device result exactly.
    """
    n_genes = tables.gene_locus_onehot.shape[0]
    model = mesh.shape["model"]
    t = len(tables.table_hashes)
    # Hash-run-aligned shard cuts (padded to a common length with the max
    # hash): a run straddling a cut would be tallied with the per-shard
    # MAX_OCC cap on both sides and psum to more than the single-device cap.
    h_full = tables.table_hashes
    cuts = [round(i * t / model) for i in range(model + 1)]
    for i in range(1, model):
        c = cuts[i]
        while 0 < c < t and h_full[c] == h_full[c - 1]:
            c += 1
        cuts[i] = max(min(c, t), cuts[i - 1])
    shard_len = max(max(cuts[i + 1] - cuts[i] for i in range(model)), 1)
    th = np.full(model * shard_len, np.uint32(0xFFFFFFFF), dtype=np.uint32)
    tg = np.zeros(model * shard_len, dtype=np.int32)
    for si in range(model):
        lo, hi = cuts[si], cuts[si + 1]
        th[si * shard_len : si * shard_len + (hi - lo)] = h_full[lo:hi]
        tg[si * shard_len : si * shard_len + (hi - lo)] = tables.table_genes[lo:hi]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("data", None),  # assemblies
            P("model"),  # table hashes (hash-range shards)
            P("model"),  # table gene ids
            P(),  # onehot replicated
            P(),  # expected counts replicated
            P(),  # minimizer counts replicated
        ),
        out_specs=(P("data"), P("data", None)),
    )
    def step(codes, th_s, tg_s, onehot, exp, gmc):
        tallies = jax.vmap(lambda c: _tally_one(c, th_s, tg_s, n_genes))(codes)
        tallies = jax.lax.psum(tallies, "model")
        return _score_from_tallies(tallies, onehot, exp, gmc)

    # device_put host numpy straight onto the mesh with explicit shardings.
    # Never go through a default-device jnp.asarray first: the default device
    # may be a different platform than the mesh (e.g. a GPU while the mesh is
    # a virtual CPU mesh), and a cross-platform reshard can stall.
    def put(x, spec):
        return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))

    return step(
        put(codes_batch, P("data", None)),
        put(th, P("model")),
        put(tg, P("model")),
        put(tables.gene_locus_onehot, P()),
        put(tables.expected_per_locus, P()),
        put(tables.gene_minimizer_counts, P()),
    )


def encode_assemblies_to_batch(assemblies, pad_to: int | None = None) -> np.ndarray:
    r"""Host: encode each assembly's contigs into one fixed-width code row."""
    from kaptive_tpu.ops.minimizer import DEFAULT_K, concat_with_sentinels, encode_dna

    rows = []
    for ga in assemblies:
        codes = encode_dna(ga.contigs.seqs)
        flat, _ = concat_with_sentinels(codes, ga.contigs.offsets, ga.contigs.lengths, DEFAULT_K)
        rows.append(flat)
    width = pad_to or max((len(r) for r in rows), default=1)
    out = np.full((len(rows), width), 4, dtype=np.uint8)  # sentinel padding
    for i, r in enumerate(rows):
        out[i, : min(len(r), width)] = r[:width]
    return out
