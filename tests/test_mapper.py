"""Seed-chain-extend mapper tests on synthetic assemblies with known truth."""

import io

import numpy as np
import pytest

from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.core.seq import Sequences
from kaptive_tpu.ops.mapper import GeneIndex, MapperParams, map_genes
from kaptive_tpu.ops.minimizer import build_minimizer_set
from synthetic import mutate_dna, random_dna, revcomp


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def _assembly(contigs: dict[str, bytes]) -> GenomeAssembly:
    fasta = b"".join(b">%s\n%s\n" % (k.encode(), v) for k, v in contigs.items())
    return GenomeAssembly.from_stream(io.BytesIO(fasta), "synthetic")


def test_minimizers_basic(rng):
    seqs = Sequences.from_bytes([random_dna(rng, 3000), random_dna(rng, 500)])
    ms = build_minimizer_set(seqs)
    # Expected density ~ 2/(w+1) per position
    assert 200 < len(ms.hashes) < 1200
    assert ms.hashes.dtype == np.uint32
    assert (np.diff(ms.hashes.astype(np.int64)) >= 0).all()  # sorted
    assert set(np.unique(ms.seq_indices)) == {0, 1}


def test_minimizers_revcomp_invariance(rng):
    seq = random_dna(rng, 2000)
    fwd = build_minimizer_set(Sequences.from_bytes([seq]), sort=True)
    rev = build_minimizer_set(Sequences.from_bytes([revcomp(seq)]), sort=True)
    # Canonical hashing: near-identical hash multisets from both strands.
    # (Partial windows at sequence ends may add a few edge minimizers on one
    # strand but not the other; interior selection is strand-symmetric.)
    inter = np.intersect1d(fwd.hashes, rev.hashes)
    assert len(inter) >= 0.97 * max(len(fwd.hashes), len(rev.hashes))


def test_map_exact_gene(rng):
    genes = [random_dna(rng, 900), random_dna(rng, 1200), random_dna(rng, 600)]
    gseqs = Sequences.from_bytes(genes)
    gidx = GeneIndex.build(gseqs)
    # Plant gene 0 forward at 5000, gene 1 revcomp at 8000 in a 20kb contig
    bg = random_dna(rng, 20000)
    contig = bg[:5000] + genes[0] + bg[5000:8000] + revcomp(genes[1]) + bg[8000:]
    ga = _assembly({"ctg1": contig})
    alns = map_genes(gidx, ga, tuple(str(i) for i in range(3)))

    assert len(alns) >= 2
    by_gene = {}
    for i in range(len(alns)):
        g = int(alns.q_names_dict[alns.q_name_ids[i]])
        if g not in by_gene or alns.scores[i] > alns.scores[by_gene[g]]:
            by_gene[g] = i

    # Gene 0: perfect forward hit covering whole gene
    i0 = by_gene[0]
    assert alns.strands[i0] == 1
    assert alns.q_starts[i0] == 0 and alns.q_ends[i0] == 900
    assert alns.t_starts[i0] == 5000 and alns.t_ends[i0] == 5900
    assert alns.matches[i0] == 900
    assert alns.mismatches[i0] == 0  # edit distance

    # Gene 1: perfect reverse hit
    i1 = by_gene[1]
    assert alns.strands[i1] == -1
    assert alns.q_starts[i1] == 0 and alns.q_ends[i1] == 1200
    assert alns.matches[i1] == 1200
    t0 = 5000 + 900 + 3000
    assert alns.t_starts[i1] == t0 and alns.t_ends[i1] == t0 + 1200

    # Gene 2 was not planted: no strong full-length hit
    if 2 in by_gene:
        assert alns.q_covs[by_gene[2]] < 0.5


def test_map_mutated_gene(rng):
    gene = random_dna(rng, 1000)
    gseqs = Sequences.from_bytes([gene])
    gidx = GeneIndex.build(gseqs)
    mutated = mutate_dna(rng, gene, sub_rate=0.10, indel_rate=0.01)
    contig = random_dna(rng, 3000) + mutated + random_dna(rng, 3000)
    ga = _assembly({"c": contig})
    alns = map_genes(gidx, ga, ("0",))
    assert len(alns) >= 1
    best = int(np.argmax(alns.scores))
    assert alns.q_covs[best] > 0.85
    # ~10% divergence -> identity in 85-95% range
    ident = alns.matches[best] / (alns.q_ends[best] - alns.q_starts[best])
    assert 0.8 < ident < 0.99


def test_map_gene_split_across_contigs(rng):
    gene = random_dna(rng, 1500)
    gidx = GeneIndex.build(Sequences.from_bytes([gene]))
    # Fragment the gene across two contigs
    ga = _assembly({
        "a": random_dna(rng, 2000) + gene[:800],
        "b": gene[800:] + random_dna(rng, 2000),
    })
    alns = map_genes(gidx, ga, ("0",))
    tnames = [alns.t_names_dict[t] for t in alns.t_name_ids]
    assert "a" in tnames and "b" in tnames
    for i in range(len(alns)):
        if alns.t_names_dict[alns.t_name_ids[i]] == "a":
            assert alns.q_starts[i] == 0 and abs(int(alns.q_ends[i]) - 800) <= 2
            assert abs(int(alns.t_ends[i]) - 2800) <= 2
        else:
            assert abs(int(alns.q_starts[i]) - 800) <= 2 and alns.q_ends[i] == 1500


def test_map_empty_assembly(rng):
    gidx = GeneIndex.build(Sequences.from_bytes([random_dna(rng, 500)]))
    ga = _assembly({"empty": b""})
    alns = map_genes(gidx, ga, ("0",))
    assert len(alns) == 0


def test_mapper_emits_cigars_consistent_with_stats():
    """do_cigar parity: BAM CIGAR runs must reconcile with the DP statistics.

    For every hit: sum(M)+sum(I) == aligned query span, sum(M)+sum(D) ==
    aligned target span, sum(M) == matches+mismatches, and the byte-string
    round-trip through parse_cigar_string is lossless.  (Reference maps with
    do_cigar=True — /root/reference/src/kaptive/serotyping/core.py:148.)
    """
    import io

    import numpy as np

    from kaptive_tpu.core.alignment import parse_cigar_string
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.db import Database
    from kaptive_tpu.ops.mapper import MapperParams, map_genes
    from synthetic import make_genome_from_locus, make_synthetic_db

    rng = np.random.default_rng(11)
    import tempfile
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp())
    gbk, truth = make_synthetic_db(tmp, rng, n_loci=3, genes_per_locus=4)
    db = Database.from_genbank(gbk)
    # Indels + substitutions so CIGARs contain I/D runs, not just one M.
    from synthetic import mutate_dna, random_dna

    locus = mutate_dna(rng, truth["loci"]["KL2"]["seq"], sub_rate=0.02, indel_rate=0.005)
    contig = random_dna(rng, 4000) + locus + random_dna(rng, 4000)
    ga = GenomeAssembly.from_stream(io.BytesIO(b">c1\n%s\n" % contig), "cig")

    names = tuple(str(i) for i in range(len(db.genes)))
    alns = map_genes(db.gene_index, ga, names, MapperParams(emit_cigars=True))
    assert len(alns) > 0
    assert len(alns.cigars) == len(alns)
    checked = 0
    for r in range(len(alns)):
        ops = alns.cigars[r]
        if len(ops) == 0:  # overflow fallback leaves stats-only hits
            continue
        kinds = ops & 0xF
        runs = ops >> 4
        m = int(runs[kinds == 0].sum())
        ins = int(runs[kinds == 1].sum())
        dele = int(runs[kinds == 2].sum())
        assert m + ins == alns.q_ends[r] - alns.q_starts[r]
        assert m + dele == alns.t_ends[r] - alns.t_starts[r]
        assert m == alns.matches[r] + (alns.mismatches[r] - dele - ins)  # NM = mism+gaps
        # adjacent runs must alternate op kinds (proper run-length encoding)
        assert np.all(kinds[1:] != kinds[:-1])
        checked += 1
    assert checked > 0
    # round-trip through the byte-string form
    strings = alns.cigars.to_strings()
    for r in range(len(alns)):
        np.testing.assert_array_equal(parse_cigar_string(strings[r]), alns.cigars[r])
    # CIGAR mode shares the device-resident problem build with count-only
    # mode (round 2 silently rerouted it through the host build): the hit
    # sets and every statistic must be identical between the two modes.
    plain = map_genes(db.gene_index, ga, names, MapperParams(emit_cigars=False))
    assert len(plain) == len(alns)
    for field in ("q_starts", "q_ends", "t_starts", "t_ends", "scores",
                  "matches", "mismatches", "strands", "q_name_ids", "t_name_ids"):
        np.testing.assert_array_equal(getattr(plain, field), getattr(alns, field), err_msg=field)


def test_device_match_chain_parity_with_host(rng):
    """The row-compact match + device chainer must reproduce the host path.

    Host oracle: find_anchors (searchsorted over the full sorted table) +
    chain_anchors (numpy lexsort chaining).  Device path: rowcompact scan ->
    bloom/match -> on-device chaining.  Chain descriptor SETS must be equal.
    """
    import numpy as np
    import jax.numpy as jnp

    from kaptive_tpu.core.seq import Sequences
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.ops.mapper import (
        CANDIDATE_CAP, CHAIN_CAP, DEVICE_MAX_OCC, _CHAIN_FIELDS,
        _chain_batch, _match_rows_batch, _rowcompact_batch,
        GeneIndex, MapperParams, chain_anchors, find_anchors,
    )

    # genes planted into a genome with mutations and both strands
    genes = []
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome_parts = [rng.choice(alpha, 3000).tobytes()]
    for i in range(6):
        g = rng.choice(alpha, 400 + 100 * i).tobytes()
        genes.append((f"g{i}", g))
        ins = bytearray(g if i % 2 == 0 else g[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA")))
        for _ in range(10 + i * 5):  # point mutations
            p = rng.integers(0, len(ins))
            ins[p] = int(rng.choice(alpha))
        genome_parts.append(bytes(ins))
        genome_parts.append(rng.choice(alpha, 2000).tobytes())
    contig = b"".join(genome_parts)

    gene_seqs = Sequences.from_bytes([s for _, s in genes], tuple(gid for gid, _ in genes))
    gidx = GeneIndex.build(gene_seqs)
    import io

    ga = GenomeAssembly.from_stream(io.BytesIO(b">c1\n" + contig + b"\n"), "parity")
    ci = ga.get_minimizer_index()
    params = MapperParams()

    # Host oracle chains
    anchors_host = find_anchors(gidx, ci.minimizers, params)
    chains_host = chain_anchors(*anchors_host, gidx.lengths, gidx.k, params)

    # Device path chains
    from kaptive_tpu.ops.mapper import _packed_inputs

    pb, vb, L = _packed_inputs(ci)
    th, tg, tp, ts = gidx.device_table
    bs, rl, iters = gidx.device_lookup
    rows_h, rows_a, rows_c, _ = _rowcompact_batch(
        jnp.asarray(pb[None]), jnp.asarray(vb[None]),
        length=L, k=gidx.k, w=gidx.w,
    )
    anchors_d, counts_d = _match_rows_batch(
        rows_h, rows_a, rows_c, th, tg, tp, ts, bs, rl, gidx.device_bloom,
        CANDIDATE_CAP, 1 << 16, iters, DEVICE_MAX_OCC,
    )
    import numpy as np

    starts_pad = np.full((1, 8), np.int32(0x7FFFFFFF), np.int32)
    starts_pad[0, : len(ci.starts)] = ci.starts.astype(np.int32)
    chains_d, counts2 = _chain_batch(
        anchors_d, counts_d, jnp.asarray(starts_pad), gidx.device_gene_lengths,
        gidx.k, CHAIN_CAP, params.max_diag_drift, params.max_anchor_gap,
        params.min_anchors,
    )
    counts2 = np.asarray(counts2)
    assert int(counts2[3, 0]) == 0, "unexpected row overflow"
    n_kept = int(counts2[5, 0])  # device-compacted >= min_anchors prefix
    arr = np.asarray(chains_d)[0].astype(np.int64)
    dev = {f: arr[i][:n_kept] for i, f in enumerate(_CHAIN_FIELDS)}

    def chain_set(ch):
        return {
            tuple(int(ch[f][i]) for f in _CHAIN_FIELDS) for i in range(len(ch["gene"]))
        }

    assert len(dev["gene"]) > 0
    assert chain_set(dev) == chain_set(chains_host)
