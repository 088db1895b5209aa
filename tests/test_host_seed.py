"""Host-seeded mapping mode: native C scan+match parity and pipeline equality.

The host seeding path (``ops/mapper.host_seed_chains`` backed by
``native/hostio.cpp::seed_anchors``) must produce the exact anchor set of the
numpy reference scan (``minimizer_scan_host`` + ``find_anchors``) and, through
the full Serotyper, byte-identical report rows to the device-scan mode.
"""

import io
import os

import numpy as np
import pytest

from synthetic import make_genome_from_locus, make_synthetic_db, random_dna, revcomp


def _native():
    try:
        from kaptive_tpu.native import hostio

        return hostio
    except ImportError:
        pytest.skip("native hostio unavailable (no compiler)")


def _numpy_anchor_oracle(codes, k, w, table, max_occ):
    from kaptive_tpu.ops.minimizer import minimizer_scan_host

    sel, hashes, strands = minimizer_scan_host(codes, k, w)
    pos = np.flatnonzero(sel)
    lo = np.searchsorted(table, hashes[pos], "left")
    hi = np.searchsorted(table, hashes[pos], "right")
    cnt = np.minimum(hi - lo, max_occ)
    exp_cpos = np.repeat(pos, cnt)
    exp_ti = (
        np.concatenate([np.arange(l, l + c) for l, c in zip(lo, cnt)]).astype(np.int64)
        if cnt.sum()
        else np.empty(0, np.int64)
    )
    return pos, exp_ti, exp_cpos, strands, int((cnt > 0).sum())


def test_native_seed_anchors_matches_numpy_scan():
    """Randomized differential: C kernel == numpy scan+match bit-for-bit,
    across k/w/max_occ variants, N runs, and with/without the bloom gate."""
    hostio = _native()
    rng = np.random.default_rng(42)
    for trial in range(6):
        L = int(rng.integers(40, 150000))
        codes = rng.integers(0, 4, L).astype(np.uint8)
        for _ in range(int(rng.integers(0, 10))):
            s = int(rng.integers(0, L))
            codes[s : s + int(rng.integers(1, 40))] = 4
        k = int(rng.choice([11, 15, 16]))
        w = int(rng.choice([5, 10, 12]))
        from kaptive_tpu.ops.minimizer import minimizer_scan_host

        sel, hashes, _ = minimizer_scan_host(codes, k, w)
        mh = hashes[np.flatnonzero(sel)]
        table = np.sort(
            np.concatenate(
                [mh[::2], rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)]
            )
        )
        max_occ = int(rng.integers(1, 1025))
        BB = 20
        bit = (table.astype(np.uint64) & np.uint64((1 << BB) - 1)).astype(np.int64)
        words = np.zeros(1 << (BB - 5), dtype=np.uint32)
        np.bitwise_or.at(words, bit >> 5, np.uint32(1) << (bit & 31).astype(np.uint32))
        pos, exp_ti, exp_cpos, strands, n_cand = _numpy_anchor_oracle(
            codes, k, w, table, max_occ
        )
        SHIFT = 12
        bucket_of = (table.astype(np.int64) >> SHIFT)
        buckets = np.searchsorted(bucket_of, np.arange((1 << (32 - SHIFT)) + 1)).astype(
            np.int32
        )
        for bw, bb, bk in ((None, 0, None), (words, BB, None), (words, BB, buckets),
                           (None, 0, buckets)):
            ti, cpos, cstrand, n_min, nc = hostio.seed_anchors(
                codes, k, w, table, max_occ, bloom_words=bw, bloom_bits=bb,
                bucket_starts=bk, bucket_shift=SHIFT if bk is not None else 0,
            )
            assert n_min == len(pos)
            assert nc == n_cand
            assert np.array_equal(ti, exp_ti)
            assert np.array_equal(cpos, exp_cpos)
            assert np.array_equal(cstrand.astype(bool), strands[exp_cpos])


def test_native_build_contig_stream_differential():
    """Randomized differential for the fused encode+concat+pack+exception C
    pass (incl. its vector fast path): flat codes, packed bytes, exception
    list and counts all equal a pure-numpy oracle across alphabets that mix
    upper/lower case, U/T, ambiguity codes and junk bytes."""
    hostio = _native()
    rng = np.random.default_rng(1)
    alpha = np.frombuffer(b"ACGTacgtUuNnRYx> \t0", dtype=np.uint8)
    lut = np.full(256, 4, np.uint8)
    for ch, c in zip(b"AaCcGgTtUu", [0, 0, 1, 1, 2, 2, 3, 3, 3, 3]):
        lut[ch] = c
    gap = 14
    for trial in range(12):
        n = int(rng.integers(1, 6))
        hi = 50000 if trial % 3 == 0 else 500
        lens = rng.integers(0, hi, n).astype(np.int64)
        seqs = []
        for ln in lens:
            wgt = rng.random(ln)
            s = np.where(wgt < 0.97, alpha[rng.integers(0, 8, ln)],
                         alpha[rng.integers(0, len(alpha), ln)])
            seqs.append(s.astype(np.uint8))
        flatseq = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
        offs = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        real = int(lens.sum()) + gap * max(n - 1, 0)
        alloc = real + int(rng.integers(0, 100))
        flat, packed, exc, r2, n_exc = hostio.build_contig_stream(
            flatseq, offs, lens, gap, max(alloc, 1), 1 << 16
        )
        parts = []
        for i, s in enumerate(seqs):
            parts.append(lut[s])
            if i + 1 < n:
                parts.append(np.full(gap, 4, np.uint8))
        ref_flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        assert r2 == real == len(ref_flat)
        assert np.array_equal(flat[:real], ref_flat), trial
        assert np.all(flat[real:] == 4)
        ref_exc = np.flatnonzero(ref_flat >= 4).astype(np.int32)
        assert n_exc == len(ref_exc)
        assert np.array_equal(exc, ref_exc[: len(exc)]), trial
        codes0 = np.where(ref_flat >= 4, 0, ref_flat)
        pad = np.zeros((-len(codes0)) % 4, np.uint8)
        quads = np.concatenate([codes0, pad]).reshape(-1, 4)
        ref_packed = (
            quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
        ).astype(np.uint8)
        assert np.array_equal(packed, ref_packed), trial


def test_native_seed_anchors_chunk_boundaries():
    """Deterministic boundary panel for the vectorized kernel: stream lengths
    straddling the 32K-window chunk size and the 16-lane fill groups, plus
    invalid-base runs placed exactly at chunk seams (where the packed-buffer
    carry and the scalar pack-resume path engage)."""
    hostio = _native()
    rng = np.random.default_rng(17)
    CHUNK = 1 << 15
    k, w, max_occ = 15, 10, 64
    from kaptive_tpu.ops.minimizer import minimizer_scan_host

    for L in (CHUNK, CHUNK + 1, CHUNK - 1, 2 * CHUNK + 7, 4 * CHUNK - 9, CHUNK + k + w):
        codes = rng.integers(0, 4, L).astype(np.uint8)
        # invalid runs at the seams and mid-lane: exercises badbuf invalidation
        # across group boundaries and the dense-invalid scalar pack fallback
        for s, n in ((CHUNK - 3, 7), (2 * CHUNK - 1, 2), (5, 1), (L - 4, 3), (1000, 130)):
            if s + n <= L:
                codes[s : s + n] = 4
        sel, hashes, _ = minimizer_scan_host(codes, k, w)
        mh = hashes[np.flatnonzero(sel)]
        table = np.sort(mh[::3])
        pos, exp_ti, exp_cpos, strands, n_cand = _numpy_anchor_oracle(
            codes, k, w, table, max_occ
        )
        ti, cpos, cstrand, n_min, nc = hostio.seed_anchors(codes, k, w, table, max_occ)
        assert n_min == len(pos), L
        assert nc == n_cand, L
        assert np.array_equal(ti, exp_ti), L
        assert np.array_equal(cpos, exp_cpos), L
        assert np.array_equal(cstrand.astype(bool), strands[exp_cpos]), L


def test_native_seed_anchors_extreme_params():
    """k/w extremes (k=1..2, w=1..2, wide w, k=16 with w=1) stay bit-identical
    to the numpy scan — the vector fill's shift table and the per-block van
    Herk scans must hold at degenerate window/k-mer sizes."""
    hostio = _native()
    from kaptive_tpu.ops.minimizer import minimizer_scan_host

    rng = np.random.default_rng(9)
    for k, w in [(1, 1), (2, 1), (1, 2), (2, 2), (16, 1), (15, 2), (3, 30)]:
        L = int(rng.integers(max(k + w, 2), 70000))
        codes = rng.integers(0, 4, L).astype(np.uint8)
        codes[rng.integers(0, L, 5)] = 4
        sel, hashes, strands = minimizer_scan_host(codes, k, w)
        pos = np.flatnonzero(sel)
        table = np.sort(hashes[pos][::2]) if len(pos) else np.zeros(0, np.uint32)
        lo = np.searchsorted(table, hashes[pos], "left")
        hi = np.searchsorted(table, hashes[pos], "right")
        exp_cpos = np.repeat(pos, np.minimum(hi - lo, 1024))
        ti, cpos, cstrand, n_min, nc = hostio.seed_anchors(codes, k, w, table, 1024)
        assert n_min == len(pos), (k, w, L)
        assert np.array_equal(cpos, exp_cpos), (k, w, L)
        assert np.array_equal(cstrand.astype(bool), strands[exp_cpos]), (k, w, L)


def test_native_seed_anchors_edge_cases():
    hostio = _native()
    # Shorter than k / all-sentinel streams produce nothing, no crash.
    for codes in (np.zeros(5, np.uint8), np.full(200, 4, np.uint8)):
        ti, cpos, cstrand, n_min, n_cand = hostio.seed_anchors(
            codes, 15, 10, np.zeros(0, np.uint32), 16
        )
        assert len(ti) == 0 and n_min == 0 and n_cand == 0
    # Tiny cap_out grows and retries; counts stay exact.
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    from kaptive_tpu.ops.minimizer import minimizer_scan_host

    sel, hashes, _ = minimizer_scan_host(codes, 15, 10)
    table = np.sort(hashes[np.flatnonzero(sel)])
    small = hostio.seed_anchors(codes, 15, 10, table, 1024, cap_out=4)
    big = hostio.seed_anchors(codes, 15, 10, table, 1024)
    assert np.array_equal(small[0], big[0]) and np.array_equal(small[1], big[1])


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hostseed")
    rng = np.random.default_rng(5)
    gbk, truth = make_synthetic_db(tmp, rng, n_loci=4)
    from kaptive_tpu.db import Database

    db = Database.from_genbank(gbk)
    loc3 = truth["loci"]["KL3"]["seq"]
    loc4 = truth["loci"]["KL4"]["seq"]
    loc1 = truth["loci"]["KL1"]["seq"]
    half = len(loc4) // 2
    genomes = [
        ("clean", make_genome_from_locus(rng, truth, "KL1")),
        ("diverged", make_genome_from_locus(rng, truth, "KL2", sub_rate=0.01)),
        ("revcomp", b">c1\n" + random_dna(rng, 2500) + revcomp(loc3) + random_dna(rng, 2500) + b"\n"),
        ("split", b">c1\n" + random_dna(rng, 2000) + loc4[:half] + b"\n>c2\n"
         + loc4[half:] + random_dna(rng, 2000) + b"\n"),
        ("n_heavy", b">c1\n" + random_dna(rng, 3000) + b"N" * 500 + loc1[: len(loc1) // 2]
         + b"NNNN" + loc1[len(loc1) // 2 :] + random_dna(rng, 3000) + b"\n"),
    ]
    return db, genomes


def _rows(db, genomes, mode, monkeypatch):
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.serotyping import Serotyper
    from kaptive_tpu.serotyping.io import KaptiveRow

    monkeypatch.setenv("KAPTIVE_SEED_MODE", mode)
    serotyper = Serotyper(db)
    return [
        bytes(KaptiveRow.from_result(serotyper(GenomeAssembly.from_stream(io.BytesIO(f), n))))
        for n, f in genomes
    ]


def test_host_seed_rows_match_device_mode(panel, monkeypatch):
    """Full Serotyper: host-seeded and device-scan modes produce byte-identical
    22-column rows on clean/diverged/revcomp/split/N-heavy panels."""
    db, genomes = panel
    assert _rows(db, genomes, "host", monkeypatch) == _rows(db, genomes, "device", monkeypatch)


def test_host_seed_chains_equal_fallback_anchors(panel, monkeypatch):
    """host_seed_chains (native) == chain_anchors over find_anchors (numpy)."""
    db, genomes = panel
    _native()
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.ops.mapper import (
        MapperParams,
        chain_anchors,
        find_anchors,
        host_seed_chains,
    )

    gi = db.gene_index
    params = MapperParams()
    for name, fasta in genomes:
        ci = GenomeAssembly.from_stream(io.BytesIO(fasta), name).get_minimizer_index()
        native_chains = host_seed_chains(gi, ci, params)
        ref_chains = chain_anchors(
            *find_anchors(gi, ci.minimizers, params), gi.lengths, gi.k, params
        )
        assert set(native_chains) == set(ref_chains)
        for key in native_chains:
            np.testing.assert_array_equal(native_chains[key], ref_chains[key], err_msg=key)


def test_preseed_cache_keyed_by_database(panel, monkeypatch):
    """A ContigIndex pre-seeded against one database must NOT feed its chains
    to a Serotyper built from a different database — stale entries re-seed."""
    db, genomes = panel
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.ops.mapper import MapperParams, host_seed_chains, map_genes_batch

    gi = db.gene_index
    params = MapperParams()
    ga = GenomeAssembly.from_stream(io.BytesIO(genomes[0][1]), "g")
    ci = ga.get_minimizer_index()
    fresh = map_genes_batch(gi, [ga], tuple(str(i) for i in range(len(db.genes))),
                            params, seed_mode="host")[0]
    # Poison the cache with chains keyed to a DIFFERENT gene_index object.
    decoy = object()
    ci._cache["host_chains"] = (decoy, params, {"gene": np.array([0])})
    redo = map_genes_batch(gi, [ga], tuple(str(i) for i in range(len(db.genes))),
                           params, seed_mode="host")[0]
    assert len(redo) == len(fresh) and np.array_equal(redo.scores, fresh.scores)
    # A correctly-keyed entry IS consumed.
    ci._cache["host_chains"] = (gi, params, host_seed_chains(gi, ci, params))
    again = map_genes_batch(gi, [ga], tuple(str(i) for i in range(len(db.genes))),
                            params, seed_mode="host")[0]
    assert np.array_equal(again.scores, fresh.scores)


def test_stream_type_preseeds_host_chains(panel, monkeypatch):
    """stream_type in host mode computes chains on the ingest pool (the mapping
    phase consumes the pre-seeded cache) and yields correct calls."""
    db, genomes = panel
    from kaptive_tpu.parallel.pipeline import stream_type
    from kaptive_tpu.serotyping import Serotyper
    from kaptive_tpu.utils.metrics import metrics_report, reset_metrics

    monkeypatch.setenv("KAPTIVE_SEED_MODE", "host")
    reset_metrics()
    serotyper = Serotyper(db)
    handles = [io.BytesIO(f) for _, f in genomes]
    results = list(stream_type(serotyper, handles, batch_size=2))
    assert [r.best_locus_name for r in results] == ["KL1", "KL2", "KL3", "KL4", "KL1"]
    counters = metrics_report()
    assert counters.get("map.host_seed.preseeded", 0) == len(genomes)
