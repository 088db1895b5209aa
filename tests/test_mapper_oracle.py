"""Independent hit-level oracle for the device mapper.

The golden harness proves everything downstream of the mapper byte-identical,
but it feeds BOTH engines our mapper's hits — a systematic mapper bias
(dropped hit, coordinate off-by-one under divergence) would pass every golden
test.  This module re-implements the documented seed-chain-extend contract
(``kaptive_tpu/ops/mapper.py`` module docstring; minimizer definition in
``kaptive_tpu/ops/minimizer.py``) from scratch — sliding-window numpy
minimizers, dict-based anchor lookup, spec-level chaining, and the
cell-at-a-time DP oracle of ``tests/oracles.py`` — sharing NO code with
``ops/mapper.py``/``ops/minimizer.py``, and differential-tests the device
mapper against it over >=1000 planted genes at 0-10% divergence:

1. hit SETS: per genome, the (gene, contig, strand) triples of device hits
   must equal the oracle's chained triples both ways (nothing dropped,
   nothing invented);
2. hit PLACEMENT: every device hit's target interval must lie inside the
   oracle chain's projected extension window;
3. exact stats on a sampled subset: score / matches / mismatches / gaps /
   NM / q+t coordinates from the sequential DP oracle must match the device
   hit field-for-field;
4. band adequacy: for a smaller sample, an (effectively) unbanded SW over
   the window must reproduce the banded score and coordinates.
"""

import io
import tempfile
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest

from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.db import Database
from kaptive_tpu.ops.mapper import MapperParams, map_genes_batch
from oracles import banded_swg_oracle
from synthetic import make_synthetic_db, mutate_dna, random_dna

K, W = 15, 10
MAX_DIAG_DRIFT, MAX_ANCHOR_GAP = 100, 2000
WINDOW_PAD, BAND_SLACK, MIN_SCORE, MIN_ANCHORS = 64, 48, 30, 2
NT_MATCH, NT_MISMATCH, NT_GAP_OPEN, NT_GAP_EXTEND = 2, -4, 4, 2

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[_c + 32] = _i

_NT = np.full((256, 256), NT_MISMATCH, dtype=np.int64)
for _b in range(4):
    _NT[_b, _b] = NT_MATCH


def _murmur3_fmix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32).copy()
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def oracle_minimizers(seq: bytes):
    """(positions, hashes, fwd_is_canonical) of the sequence's minimizers.

    Independent formulation: stride-tricks k-mer windows, base-4 positional
    packing (== the 2-bit big-endian packing), canonical = min(fwd, revcomp),
    murmur3 finalizer, sliding-window minimum with leftmost-on-tie argmin.
    """
    codes = _CODE[np.frombuffer(seq, dtype=np.uint8)]
    L = len(codes)
    if L < K + W - 1:
        z = np.empty(0, dtype=np.int64)
        return z, z.astype(np.uint32), z.astype(bool)
    win = np.lib.stride_tricks.sliding_window_view(codes, K)
    valid = (win < 4).all(axis=1)
    p4 = (np.uint64(4) ** np.arange(K - 1, -1, -1, dtype=np.uint64))
    fwd = (win.astype(np.uint64) * p4).sum(axis=1)
    rev = ((np.uint64(3) - win[:, ::-1].astype(np.uint64)) * p4).sum(axis=1)
    canonical = np.minimum(fwd, rev)
    fwd_canonical = fwd <= rev
    h = np.where(valid, _murmur3_fmix32(canonical), np.uint32(0xFFFFFFFF))
    hw = np.lib.stride_tricks.sliding_window_view(h, W)
    best = hw.min(axis=1)
    arg = hw.argmin(axis=1)  # first occurrence == leftmost-on-tie
    starts = np.flatnonzero(best != np.uint32(0xFFFFFFFF))
    pos = np.unique(starts + arg[starts])
    return pos.astype(np.int64), h[pos], fwd_canonical[pos]


def oracle_chains(db, contigs: list[bytes], gene_mins, gene_lengths):
    """Anchor + single-linkage chain every gene against every contig."""
    table = defaultdict(list)
    for g, (pos, hashes, strands) in enumerate(gene_mins):
        for p, h, s in zip(pos, hashes, strands):
            table[int(h)].append((g, int(p), bool(s)))

    rows = []
    for ctg, seq in enumerate(contigs):
        c_pos, c_h, c_st = oracle_minimizers(seq)
        for p, h, s in zip(c_pos, c_h, c_st):
            for g, gp, gs in table.get(int(h), ()):
                rel = 1 if gs == bool(s) else -1
                qp = gp if rel > 0 else int(gene_lengths[g]) - K - gp
                rows.append((g, ctg, rel, int(p) - qp, int(p), qp))
    if not rows:
        return []
    arr = np.array(rows, dtype=np.int64)
    g, c, r, d, t, q = arr.T
    order = np.lexsort((t, d, r, c, g))
    g, c, r, d, t, q = (x[order] for x in (g, c, r, d, t, q))
    brk = np.ones(len(g), dtype=bool)
    brk[1:] = (
        (g[1:] != g[:-1]) | (c[1:] != c[:-1]) | (r[1:] != r[:-1])
        | ((d[1:] - d[:-1]) > MAX_DIAG_DRIFT)
        | (np.abs(t[1:] - t[:-1]) > MAX_ANCHOR_GAP)
    )
    cid = np.cumsum(brk) - 1
    chains = []
    for i in range(cid[-1] + 1):
        m = cid == i
        if m.sum() < MIN_ANCHORS:
            continue
        chains.append(dict(
            gene=int(g[m][0]), ctg=int(c[m][0]), strand=int(r[m][0]),
            t_min=int(t[m].min()), t_max=int(t[m].max()),
            q_min=int(q[m].min()), q_max=int(q[m].max()),
            d_min=int(d[m].min()), d_max=int(d[m].max()),
        ))
    return chains


def _revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(codes.dtype)


def oracle_extend(chain, gene_codes, contig_codes, full_band: bool = False):
    """Project the chain to a banded DP problem and solve it cell-at-a-time."""
    glen = len(gene_codes)
    clen = len(contig_codes)
    t_lo = max(chain["t_min"] - chain["q_min"] - WINDOW_PAD, 0)
    t_hi = min(chain["t_max"] + K + (glen - chain["q_max"] - K) + WINDOW_PAD, clen)
    d_mid = (chain["d_min"] + chain["d_max"]) // 2
    offset = -(d_mid - t_lo)
    k_local = (chain["d_max"] - chain["d_min"]) // 2 + BAND_SLACK
    q = gene_codes if chain["strand"] > 0 else _revcomp_codes(gene_codes)
    t = contig_codes[t_lo:t_hi]
    if full_band:
        k_local = glen + len(t)  # band covers the entire matrix
    res = banded_swg_oracle(
        q.astype(np.int64), t.astype(np.int64), _NT, k_local,
        NT_GAP_OPEN, NT_GAP_EXTEND, is_seeded=True, diag_offset=offset,
    )
    fwd = chain["strand"] > 0
    q_start = res["q_start"] if fwd else glen - res["q_end"]
    q_end = res["q_end"] if fwd else glen - res["q_start"]
    return dict(
        score=res["score"], matches=res["matches"], mismatches=res["mismatches"],
        gaps=res["gaps"], q_start=q_start, q_end=q_end,
        t_start=t_lo + res["t_start"], t_end=t_lo + res["t_end"],
        t_lo=t_lo, t_hi=t_hi,
    )


@pytest.fixture(scope="module")
def panel():
    """10-locus DB; 10 genomes x 6 planted loci at 0-10%% divergence

    (>= 1000 planted genes total, mixed strands, all divergence classes).
    """
    rng = np.random.default_rng(20260821)
    tmp = Path(tempfile.mkdtemp())
    gbk, truth = make_synthetic_db(
        tmp, rng, n_loci=10, genes_per_locus=18, name="OracleDB",
        keyword="oracle_db", with_extra=False, with_phenotypes=False,
    )
    db = Database.from_genbank(gbk)
    rates = (0.0, 0.01, 0.02, 0.05, 0.10)
    locus_names = list(truth["loci"].keys())
    genomes, contig_sets, planted = [], [], 0
    for gi in range(10):
        parts = [random_dna(rng, 2500)]
        for li in range(6):
            ln = locus_names[(gi + li) % len(locus_names)]
            rate = rates[(gi * 6 + li) % len(rates)]
            locus = truth["loci"][ln]["seq"]
            parts.append(mutate_dna(rng, locus, sub_rate=rate) if rate else locus)
            parts.append(random_dna(rng, 1200))
            planted += len(truth["loci"][ln]["genes"])
        parts.append(random_dna(rng, 1300))
        contigs = [b"".join(parts)]
        contig_sets.append(contigs)
        fasta = b"".join(b">c%d\n%s\n" % (i, c) for i, c in enumerate(contigs))
        genomes.append(GenomeAssembly.from_stream(io.BytesIO(fasta), f"g{gi}"))
    assert planted >= 1000
    gene_seqs = [
        db.genes.seqs[db.genes.offsets[i] : db.genes.offsets[i] + db.genes.lengths[i]]
        .tobytes()
        for i in range(len(db.genes))
    ]
    gene_mins = [oracle_minimizers(s) for s in gene_seqs]
    gene_codes = [_CODE[np.frombuffer(s, dtype=np.uint8)] for s in gene_seqs]
    names = tuple(str(i) for i in range(len(db.genes)))
    alns_list = map_genes_batch(db.gene_index, genomes, names, MapperParams())
    chains_list = [
        oracle_chains(db, contigs, gene_mins, db.genes.lengths)
        for contigs in contig_sets
    ]
    return db, genomes, contig_sets, gene_codes, alns_list, chains_list


def _device_hits(alns):
    out = []
    for r in range(len(alns)):
        out.append(dict(
            gene=int(alns.q_names_dict[alns.q_name_ids[r]]),
            ctg=int(alns.t_name_ids[r]),
            strand=int(alns.strands[r]),
            q_start=int(alns.q_starts[r]), q_end=int(alns.q_ends[r]),
            t_start=int(alns.t_starts[r]), t_end=int(alns.t_ends[r]),
            score=int(alns.scores[r]), matches=int(alns.matches[r]),
            nm=int(alns.mismatches[r]),
        ))
    return out


def test_hit_sets_match_oracle(panel):
    """Neither a dropped, invented, nor DUPLICATED (gene, contig, strand) mapping."""
    from collections import Counter

    _, _, _, _, alns_list, chains_list = panel
    total = 0
    for alns, chains in zip(alns_list, chains_list):
        dev_counts = Counter((h["gene"], h["ctg"], h["strand"]) for h in _device_hits(alns))
        ora_counts = Counter((c["gene"], c["ctg"], c["strand"]) for c in chains)
        assert set(dev_counts) == set(ora_counts), (
            sorted(set(ora_counts) - set(dev_counts))[:5],
            sorted(set(dev_counts) - set(ora_counts))[:5],
        )
        # Post-dedup the mapper may merge chains but must never invent extra
        # hits for a mapping beyond what the oracle chained.
        for key, n_dev in dev_counts.items():
            assert n_dev <= ora_counts[key], (key, n_dev, ora_counts[key])
        total += len(dev_counts)
    assert total >= 1000  # the panel really exercised >=1k planted genes


def test_hit_placement_inside_oracle_windows(panel):
    """Every device hit must sit inside an oracle chain's projected window."""
    _, _, _, _, alns_list, chains_list = panel
    checked = 0
    for alns, chains in zip(alns_list, chains_list):
        windows = defaultdict(list)
        for c in chains:
            t_lo = max(c["t_min"] - c["q_min"] - WINDOW_PAD, 0)
            windows[(c["gene"], c["ctg"], c["strand"])].append((t_lo, c))
        glens = panel[0].genes.lengths
        for h in _device_hits(alns):
            cands = windows[(h["gene"], h["ctg"], h["strand"])]
            glen = int(glens[h["gene"]])
            # The chain's projected extension window upper bound (the same
            # formula the oracle/mapper project with).
            assert any(
                h["t_start"] >= t_lo
                and h["t_end"] <= c["t_max"] + K + (glen - c["q_max"] - K) + WINDOW_PAD
                for t_lo, c in cands
            ), h
            checked += 1
    assert checked >= 1000


def test_sampled_hits_exact_vs_dp_oracle(panel):
    """Score/matches/mismatches/gaps/NM and all four coordinates, exactly."""
    db, _, contig_sets, gene_codes, alns_list, chains_list = panel
    rng = np.random.default_rng(5)
    checked = 0
    for g_i, (alns, chains) in enumerate(zip(alns_list, chains_list)):
        by_key = defaultdict(list)
        for c in chains:
            by_key[(c["gene"], c["ctg"], c["strand"])].append(c)
        hits = {
            (h["gene"], h["ctg"], h["strand"]): h
            for h in _device_hits(alns)
        }
        solo = [(key, cs[0]) for key, cs in by_key.items() if len(cs) == 1]
        n_dev_per_key = defaultdict(int)
        for h in _device_hits(alns):
            n_dev_per_key[(h["gene"], h["ctg"], h["strand"])] += 1
        take = rng.permutation(len(solo))[:12]
        contig_codes = [_CODE[np.frombuffer(s, np.uint8)] for s in contig_sets[g_i]]
        for t_i in take:
            key, chain = solo[t_i]
            want = oracle_extend(chain, gene_codes[key[0]], contig_codes[key[1]])
            if key in hits:  # a solo chain must yield exactly one device hit
                assert n_dev_per_key[key] == 1, (key, n_dev_per_key[key])
            if want["score"] < MIN_SCORE:
                assert key not in hits
                continue
            got = hits[key]
            for f in ("score", "matches", "q_start", "q_end", "t_start", "t_end"):
                assert got[f] == want[f], (f, got, want)
            assert got["nm"] == want["mismatches"] + want["gaps"], (got, want)
            checked += 1
    assert checked >= 60


def test_band_adequacy_full_sw(panel):
    """An unbanded SW over the window reproduces the banded hit exactly."""
    db, _, contig_sets, gene_codes, alns_list, chains_list = panel
    rng = np.random.default_rng(9)
    checked = 0
    for g_i in (0, 4, 8):  # three genomes cover all divergence classes
        alns, chains = alns_list[g_i], chains_list[g_i]
        by_key = defaultdict(list)
        for c in chains:
            by_key[(c["gene"], c["ctg"], c["strand"])].append(c)
        hits = {(h["gene"], h["ctg"], h["strand"]): h for h in _device_hits(alns)}
        solo = [(k, cs[0]) for k, cs in by_key.items() if len(cs) == 1 and k in hits]
        contig_codes = [_CODE[np.frombuffer(s, np.uint8)] for s in contig_sets[g_i]]
        for t_i in rng.permutation(len(solo))[:2]:
            key, chain = solo[t_i]
            want = oracle_extend(
                chain, gene_codes[key[0]], contig_codes[key[1]], full_band=True
            )
            got = hits[key]
            assert got["score"] == want["score"], (got, want)
            assert (got["t_start"], got["t_end"]) == (want["t_start"], want["t_end"])
            checked += 1
    assert checked == 6
