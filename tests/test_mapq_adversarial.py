"""Adversarial mapq panel: genomes whose cull ranking is mapq-sensitive.

mapq feeds the overlap-cull ranking
(``analysis.py``: lexsort keys score, matches, mapq), so a divergent mapq
convention could flip typing calls on repeat-heavy real data.  This panel
builds the geometries where that ranking actually matters — tandem gene
duplications (exact best-score ties), IS-element interruptions (split hits of
one gene competing for the same interval), and repeat-rich drafts (one gene's
sequence scattered at high copy number) — and asserts byte-identity against
the in-process reference engine consuming the same hits, plus the mapq
convention's own invariants (minimap2-style margin x low-score penalty).
"""

import io

import numpy as np
import pytest

from ref_oracle import reference_available
from synthetic import make_synthetic_db, mutate_dna, random_dna, revcomp

from test_golden_ref import _assemble, _assert_match, _both_results


@pytest.fixture(scope="module")
def db_and_truth(tmp_path_factory):
    from kaptive_tpu.db import Database

    rng = np.random.default_rng(77991133)
    tmp = tmp_path_factory.mktemp("mapqdb")
    gbk, truth = make_synthetic_db(
        tmp, rng, n_loci=4, genes_per_locus=6, name="MapqDB", keyword="mapq_db"
    )
    return Database.from_genbank(gbk), truth, rng


def _locus_and_genes(truth, name):
    r"""(locus sequence, per-gene locus-strand sequences) from the truth table.

    Truth genes are ``(cluster, start, end, strand, orf)`` tuples where the
    orf is in gene orientation; slice the locus itself so each returned gene
    is the exact on-locus sequence.
    """
    locus = truth["loci"][name]["seq"]
    genes = [locus[start:end] for _, start, end, _, _ in truth["loci"][name]["genes"]]
    return locus, genes


needs_ref = pytest.mark.skipif(
    not reference_available(), reason="reference tree not present"
)


@needs_ref
def test_tandem_duplication_bit_identical(db_and_truth):
    """A perfect second copy of one locus gene right after the locus: exact
    best-score tie => mapq 0 on both placements; the cull still has to keep
    the in-locus copy for the reconstruction both engines agree on."""
    db, truth, rng = db_and_truth
    locus, genes = _locus_and_genes(truth, "KL2")
    dup = genes[2]
    contig = (
        random_dna(rng, 6000) + locus + random_dna(rng, 800) + dup + random_dna(rng, 6000)
    )
    fasta = b">c1\n%s\n" % contig
    _assert_match(*_both_results(db, _assemble(fasta, "tandem_dup")))


@needs_ref
def test_is_element_interruption_bit_identical(db_and_truth):
    """An insertion-sequence-like 1.2 kb element dropped mid-gene splits that
    gene into two competing hits over adjacent intervals (plus extra copies of
    the element elsewhere): ranking decides which piece survives."""
    db, truth, rng = db_and_truth
    locus, genes = _locus_and_genes(truth, "KL1")
    is_element = random_dna(rng, 1200)
    target = genes[3]
    cut = locus.find(target) + len(target) // 2
    interrupted = locus[:cut] + is_element + locus[cut:]
    contig = (
        random_dna(rng, 5000)
        + interrupted
        + random_dna(rng, 2000)
        + is_element
        + random_dna(rng, 2000)
        + revcomp(is_element)
        + random_dna(rng, 5000)
    )
    _assert_match(*_both_results(db, _assemble(b">c1\n%s\n" % contig, "is_interrupt")))


@needs_ref
def test_repeat_rich_draft_bit_identical(db_and_truth):
    """Five diverged scattered copies of one locus gene across a fragmented
    draft: secondary placements at varying margins exercise the full mapq
    range inside the cull ordering."""
    db, truth, rng = db_and_truth
    locus, genes = _locus_and_genes(truth, "KL3")
    repeat = genes[1]
    pieces = [random_dna(rng, 3000) + locus[: len(locus) // 2]]
    pieces.append(locus[len(locus) // 2 :] + random_dna(rng, 2000))
    for i in range(5):
        copy = mutate_dna(rng, repeat, sub_rate=0.01 * (i + 1))
        pieces.append(random_dna(rng, 1500) + copy + random_dna(rng, 1500))
    fasta = b"".join(
        b">c%d\n%s\n" % (i + 1, p) for i, p in enumerate(pieces)
    )
    _assert_match(*_both_results(db, _assemble(fasta, "repeat_draft")))


def test_mapq_convention_invariants(db_and_truth):
    """The emitted mapq follows the minimap2 convention: secondaries are 0,
    exact-tie primaries are 0, unique strong placements are high, and weak
    (low-score) placements are penalised even when unique."""
    db, truth, rng = db_and_truth
    from kaptive_tpu.ops.mapper import map_genes
    from kaptive_tpu.serotyping import Serotyper

    locus, genes = _locus_and_genes(truth, "KL2")
    dup = genes[2]
    contig = (
        random_dna(rng, 4000) + locus + random_dna(rng, 700) + dup + random_dna(rng, 4000)
    )
    genome = _assemble(b">c1\n%s\n" % contig, "mapq_invariants")
    s = Serotyper(db)
    alns = map_genes(db.gene_index, genome, s._gene_names, s.mapper_params)

    q = np.asarray(alns.qualities)
    primary = np.asarray(alns.is_primary)
    assert (q[~primary] == 0).all(), "secondary hits must carry mapq 0"

    gene_ids = np.asarray(alns.q_name_ids)
    scores = np.asarray(alns.scores)
    dup_gene = None
    for g in np.unique(gene_ids):
        rows = np.flatnonzero(gene_ids == g)
        if len(rows) >= 2:
            top = rows[np.argsort(-scores[rows])[:2]]
            if scores[top[0]] == scores[top[1]]:
                dup_gene = g
                assert (q[rows] == 0).all(), "exact-tie placements must report mapq 0"
    assert dup_gene is not None, "panel must contain an exact duplicate placement"

    # Unique full-length placements: margin 1, strong score => mapq 60.
    unique_strong = np.array(
        [
            len(np.flatnonzero(gene_ids == g)) == 1 and scores[gene_ids == g][0] >= 100
            for g in gene_ids
        ]
    )
    assert (q[unique_strong & primary] == 60).all()

    # Divergence is populated and sane: 0 for perfect hits, in [0, 1) always.
    de = np.asarray(alns.divergence)
    assert ((de >= 0.0) & (de < 1.0)).all()
    perfect = np.asarray(alns.mismatches) == 0  # mismatches column = edit distance
    assert np.allclose(de[perfect], 0.0)
    assert (de[~perfect] > 0).all()
