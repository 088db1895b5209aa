"""Frameshift/indel recall matrix for the gene-finding HMM.

The reference's BGC annotator calls pyfgs (FragGeneScan), whose HMM keeps
genes intact across sequencing-error frameshifts
(/root/reference/src/kaptive/bgc/annotate.py:261-278).  These tests document
the equivalent property of kaptive_tpu.bgc.genefinder: with codon-usage
emissions learned from a gene set (the annotator learns them from the
database's own genes), planted genes are recovered as ONE call under 0, 1 and
2 single-base indels, on both strands, and adjacent genes are not merged
across intergenic spacers.  Codon bias is what the discrimination rests on —
exactly as in FragGeneScan — so the fixtures use biased-codon genes
(synthetic.make_biased_orf), not random codons whose frames are statistically
indistinguishable.
"""

import numpy as np
import pytest

from synthetic import make_biased_orf, random_dna, revcomp

from kaptive_tpu.bgc.genefinder import GeneHmmParams, find_genes_hmm
from kaptive_tpu.core.seq import BacterialTranslationTable


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="module")
def params(rng):
    """Emissions learned from a training set of biased-codon genes (stands in
    for GeneHmmParams.from_sequences(db.genes) in the annotator)."""
    from kaptive_tpu.core.seq import Sequences

    train = Sequences.from_bytes([make_biased_orf(rng, 200) for _ in range(30)])
    return GeneHmmParams.from_sequences(train)


def _plant(rng, orf: bytes, strand: int = 1, flank: int = 400):
    gene = orf if strand == 1 else revcomp(orf)
    left = random_dna(rng, flank)
    right = random_dna(rng, flank)
    return left + gene + right, len(left), len(left) + len(gene)


def _apply_indels(rng, orf: bytes, n_indels: int) -> bytes:
    """Insert or delete single bases at interior positions (never in the first
    or last 60 bases, so the gene body is what frameshifts)."""
    seq = bytearray(orf)
    for _ in range(n_indels):
        pos = int(rng.integers(60, len(seq) - 60))
        if rng.random() < 0.5:
            seq.insert(pos, ord("ACGT"[rng.integers(0, 4)]))
        else:
            del seq[pos]
    return bytes(seq)


def _calls_overlapping(calls, start, end, strand):
    return [
        o for o in calls
        if o.strand == strand and min(o.end, end) - max(o.start, start) > 0.5 * (end - start)
    ]


@pytest.mark.parametrize("strand", [1, -1])
def test_clean_gene_called_exactly(rng, params, strand):
    orf = make_biased_orf(rng, 200)
    contig, start, end = _plant(rng, orf, strand)
    calls = _calls_overlapping(find_genes_hmm(contig, params, min_codons=50), start, end, strand)
    assert len(calls) == 1
    o = calls[0]
    # Coordinates within a few bases of the planted gene.
    assert abs(o.start - start) <= 9 and abs(o.end - end) <= 9
    expected = bytes(
        BacterialTranslationTable.translate(np.frombuffer(orf[:-3], dtype=np.uint8))
    )
    assert o.translation[5:50] in expected  # body matches (start refinement may trim)


@pytest.mark.parametrize("n_indels", [1, 2])
@pytest.mark.parametrize("strand", [1, -1])
def test_indel_gene_called_as_one(rng, params, n_indels, strand):
    """The round-1/2 six-frame scan split these; the HMM must not."""
    hits = 0
    trials = 8
    for t in range(trials):
        orf = _apply_indels(rng, make_biased_orf(rng, 220), n_indels)
        contig, start, end = _plant(rng, orf, strand)
        calls = _calls_overlapping(
            find_genes_hmm(contig, params, min_codons=50), start, end, strand
        )
        if len(calls) == 1 and (calls[0].end - calls[0].start) > 0.9 * (end - start):
            hits += 1
    # Documented recall: >= 7/8 single-call recovery with 1-2 indels.
    assert hits >= trials - 1, f"indel recall {hits}/{trials}"


def test_indel_translation_frame_corrected(rng, params):
    """Across one deletion, the corrected translation keeps BOTH flanks
    in-frame (the downstream protein matches again after the indel)."""
    orf = make_biased_orf(rng, 220)
    seq = bytearray(orf)
    del seq[330]  # one deleted base mid-gene
    contig, start, end = _plant(rng, bytes(seq), 1)
    calls = _calls_overlapping(find_genes_hmm(contig, params, min_codons=50), start, end, 1)
    assert len(calls) == 1
    expected = bytes(
        BacterialTranslationTable.translate(np.frombuffer(orf[:-3], dtype=np.uint8))
    )
    got = calls[0].translation
    assert got[5:40] in expected  # upstream of the indel
    assert expected[-40:-5] in got  # downstream of the indel back in frame


def test_adjacent_genes_not_merged(rng, params):
    a = make_biased_orf(rng, 150)
    b = make_biased_orf(rng, 150)
    spacer = random_dna(rng, 120)
    contig = random_dna(rng, 300) + a + spacer + b + random_dna(rng, 300)
    calls = [o for o in find_genes_hmm(contig, params, min_codons=50) if o.strand == 1]
    sa, ea = 300, 300 + len(a)
    sb, eb = ea + len(spacer), ea + len(spacer) + len(b)
    in_a = _calls_overlapping(calls, sa, ea, 1)
    in_b = _calls_overlapping(calls, sb, eb, 1)
    assert len(in_a) == 1 and len(in_b) == 1
    assert in_a[0] is not in_b[0]  # two distinct calls, not one merged span


def test_learned_params_forbid_stops(rng, params):
    assert (params.codon_logodds[[48, 50, 56]] <= -1e8).all()


def test_uniform_params_still_call_clean_genes(rng):
    """Without codon bias the HMM degrades to an indel-tolerant ORF caller but
    must still call a long clean gene."""
    orf = make_biased_orf(rng, 200)
    contig, start, end = _plant(rng, orf, 1)
    calls = _calls_overlapping(
        find_genes_hmm(contig, GeneHmmParams.uniform(), min_codons=50), start, end, 1
    )
    assert len(calls) >= 1


def test_empty_and_short():
    assert find_genes_hmm(b"") == []
    assert find_genes_hmm(b"ATGAAATAA") == []


def test_viterbi_bucket_padding_invariance():
    """Shape-bucket padding must not change the decode — especially for genes
    truncated by the contig end (a -BIG pad emission strands in-flight coding
    paths and silently drops them; the pad uses free codon emissions instead)."""
    from unittest import mock

    import kaptive_tpu.ops.minimizer as minz
    from kaptive_tpu.bgc import genefinder as gf
    from synthetic import make_orf

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    params = gf.GeneHmmParams.uniform(coding_bonus=0.40)
    cases = []
    for cut in (0, 1, 2, 10, 40):  # genes abutting the contig end, mid-codon too
        orf = make_orf(rng, 40)
        cases.append(bases[rng.integers(0, 4, 200)].tobytes() + orf[: len(orf) - 3 - cut])
    cases.append(  # interior gene control
        bases[rng.integers(0, 4, 150)].tobytes() + make_orf(rng, 50)
        + bases[rng.integers(0, 4, 150)].tobytes()
    )
    for contig in cases:
        codes = gf._DNA_LUT[np.frombuffer(contig, np.uint8)]
        padded = gf._strand_genes(codes, params, min_codons=20)
        with mock.patch.object(minz, "bucket_length", lambda n, minimum=0: n):
            unpadded = gf._strand_genes(codes, params, min_codons=20)
        assert padded == unpadded
        assert padded, "end-truncated gene must not be dropped"
