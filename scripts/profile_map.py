#!/usr/bin/env python3
"""Per-stage device timing of the scan -> match -> chain -> extension path.

``map.scan_sync`` (one batched D2H blocking on all chunk compute) hides the
queue-wait vs execution split.  This script dispatches each
device stage separately with a hard block between stages, several reps, on the
real bench fixtures — so the numbers are EXECUTION time per stage (plus one
queue entry each), not pipeline attribution.

Usage: python scripts/profile_map.py [n_genomes]
"""

import io
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))

import numpy as np


def block(tree):
    import jax

    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return tree


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    reps = int(os.environ.get("PROFILE_REPS", "5"))

    from bench import build_fixtures
    import jax.numpy as jnp

    from kaptive_tpu.ops import mapper as M
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.ops.minimizer import ContigIndex
    from kaptive_tpu.ops.rowscan import rowcompact_scan_xla

    db, assemblies = build_fixtures()
    gene_index = db.gene_index
    params = M.MapperParams()

    gas = [
        GenomeAssembly.from_stream(io.BytesIO(fasta), name)
        for name, _, _, fasta in assemblies[:n]
    ]
    indexes = [ContigIndex.build(ga.contigs) for ga in gas]
    sparse_rows = [M._device_inputs_sparse(ci) for ci in indexes]
    assert all(s is not None for s in sparse_rows)

    L = 1
    longest = max(int(ci.codes.shape[0]) for ci in indexes)
    step = 1 << 20
    L = max(-(-longest // step) * step, step)

    th, tg, tp, ts = gene_index.device_table
    bs, rl, iters = gene_index.device_lookup
    print(f"# L={L} n={n} chunk={M.SCAN_CHUNK} reps={reps}")

    c_pad = 32
    while c_pad < max(len(ci.starts) for ci in indexes):
        c_pad *= 2
    starts_pad = np.full((n, c_pad), np.int32(0x7FFFFFFF), np.int32)
    for b, ci in enumerate(indexes):
        starts_pad[b, : len(ci.starts)] = ci.starts.astype(np.int32)

    w4 = max(int(s[0].shape[0]) for s in sparse_rows)
    e_q = max(int(s[1].shape[0]) for s in sparse_rows)

    def chunk_inputs(c0):
        hi = min(c0 + M.SCAN_CHUNK, n)
        ps, es, rs = [], [], []
        for i in range(c0, c0 + M.SCAN_CHUNK):
            if i < hi:
                p, e, r = sparse_rows[i]
                if int(p.shape[0]) < w4:
                    p = jnp.pad(p, (0, w4 - int(p.shape[0])))
                if int(e.shape[0]) < e_q:
                    e = jnp.pad(e, (0, e_q - int(e.shape[0])), constant_values=0x40000000)
                ps.append(p)
                es.append(e)
                rs.append(int(r))
            else:
                ps.append(jnp.zeros(w4, dtype=jnp.uint8))
                es.append(jnp.full(e_q, 0x40000000, dtype=jnp.int32))
                rs.append(0)
        sc = jnp.asarray(starts_pad[c0:hi])
        if hi - c0 < M.SCAN_CHUNK:
            sc = jnp.pad(sc, ((0, M.SCAN_CHUNK - (hi - c0)), (0, 0)), constant_values=0x7FFFFFFF)
        return jnp.stack(ps), jnp.stack(es), jnp.asarray(rs, dtype=jnp.int32), sc

    stages = {}

    def timed(label, fn, *args, **kw):
        ts_ = []
        out = None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = block(fn(*args, **kw))
            ts_.append(time.perf_counter() - t0)
        stages[label] = ts_
        return out

    for c0 in range(0, n, M.SCAN_CHUNK):
        packed, exc, real, sc = chunk_inputs(c0)
        block((packed, exc, real, sc))

        padded, flat_c = timed(
            f"unpack[{c0}]", M._unpack_batch_sparse, packed, exc, real, length=L
        )
        rows_h, rows_a, rows_c = timed(
            f"scan[{c0}]", rowcompact_scan_xla, padded, gene_index.k, gene_index.w
        )
        anchors = timed(
            f"match[{c0}]",
            M._match_rows_batch,
            rows_h, rows_a, rows_c, th, tg, tp, ts, bs, rl,
            gene_index.device_bloom,
            M.CANDIDATE_CAP, M.ANCHOR_CAP, iters, min(params.max_occ, M.DEVICE_MAX_OCC),
        )
        anchors_d, counts_d = anchors
        timed(
            f"chain[{c0}]",
            M._chain_batch,
            anchors_d, counts_d, sc, gene_index.device_gene_lengths,
            gene_index.k, M.CHAIN_CAP,
            params.max_diag_drift, params.max_anchor_gap, params.min_anchors,
        )

    print(f"\n{'stage':<14} {'median':>9} {'min':>9} {'max':>9}")
    totals: dict[str, float] = {}
    for label, ts_ in stages.items():
        med = statistics.median(ts_)
        name = label.split("[")[0]
        totals[name] = totals.get(name, 0.0) + med
        print(f"{label:<14} {med * 1e3:8.1f}ms {min(ts_) * 1e3:8.1f}ms {max(ts_) * 1e3:8.1f}ms")
    print("\nper-stage totals over all chunks (median reps):")
    for name, tot in totals.items():
        print(f"  {name:<10} {tot * 1e3:8.1f}ms")
    print(f"  TOTAL      {sum(totals.values()) * 1e3:8.1f}ms for {n} genomes")


if __name__ == "__main__":
    main()
