"""End-to-end serotyping tests on synthetic assemblies with known true locus calls.

The oracle is construction: assemblies are built from the synthetic database's
own loci (perfect / mutated / fragmented / gene-deleted), so the correct
typing call is known by design — the strategy SURVEY.md §4 prescribes given
the reference's DBs and native deps are unavailable offline.
"""

import io
import json

import numpy as np
import pytest

from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.db import Database
from kaptive_tpu.serotyping import (
    GeneState,
    KaptiveRow,
    Pha4geRow,
    Serotyper,
    SerotypingProblem,
    SerotypingResult,
)
from synthetic import make_synthetic_db, mutate_dna, random_dna, revcomp


@pytest.fixture(scope="module")
def db_and_truth(tmp_path_factory):
    rng = np.random.default_rng(123)
    tmp = tmp_path_factory.mktemp("db")
    gbk, truth = make_synthetic_db(tmp, rng, n_loci=5, genes_per_locus=6)
    return Database.from_genbank(gbk), truth, rng


def _assembly_from(contig_dict, name="sample"):
    fasta = b"".join(b">%s\n%s\n" % (k.encode(), v) for k, v in contig_dict.items())
    return GenomeAssembly.from_stream(io.BytesIO(fasta), name)


def test_perfect_locus(db_and_truth):
    db, truth, rng = db_and_truth
    locus = truth["loci"]["KL2"]["seq"]
    ga = _assembly_from({"c1": random_dna(rng, 4000) + locus + random_dna(rng, 4000)})
    res = Serotyper(db)(ga)
    assert res.best_locus_name == "KL2"
    assert res.typeable
    assert res.phenotype == "K2"
    assert res.best_locus_completeness == 1.0
    assert res.missing_expected_genes == ()
    assert res.percent_identity == pytest.approx(100.0, abs=0.01)
    # Piece bounding boxes span gene hits, excluding the locus's flanking
    # spacers (~6% of this synthetic layout), matching the reference's
    # reconstruction semantics.
    assert res.percent_coverage > 90.0
    assert len(res.locus_pieces) == 1
    assert (res.gene_states[res.gene_hits.is_inside] == GeneState.NORMAL.value).all()
    assert res.problems == SerotypingProblem.NONE


def test_reverse_strand_locus(db_and_truth):
    db, truth, rng = db_and_truth
    locus = truth["loci"]["KL3"]["seq"]
    ga = _assembly_from({"c1": random_dna(rng, 3000) + revcomp(locus) + random_dna(rng, 3000)})
    res = Serotyper(db)(ga)
    assert res.best_locus_name == "KL3"
    assert res.typeable
    assert res.phenotype == "K3"
    assert res.best_locus_completeness == 1.0


def test_mutated_locus_still_typed(db_and_truth):
    db, truth, rng = db_and_truth
    locus = mutate_dna(rng, truth["loci"]["KL4"]["seq"], sub_rate=0.02)
    ga = _assembly_from({"c1": random_dna(rng, 3000) + locus + random_dna(rng, 3000)})
    res = Serotyper(db)(ga)
    assert res.best_locus_name == "KL4"
    # ~2% nt divergence -> protein identity still above the 82.5 threshold
    assert res.percent_identity > 90.0
    assert res.typeable


def test_fragmented_locus(db_and_truth):
    db, truth, rng = db_and_truth
    locus = truth["loci"]["KL1"]["seq"]
    cut = len(locus) // 2
    ga = _assembly_from({
        "a": random_dna(rng, 2500) + locus[:cut],
        "b": locus[cut:] + random_dna(rng, 2500),
    })
    res = Serotyper(db)(ga)
    assert res.best_locus_name == "KL1"
    assert len(res.locus_pieces) == 2
    assert SerotypingProblem.FRAGMENTED in res.problems
    assert np.isnan(res.length_discrepancy)
    # Partial genes at the contig edges should be flagged
    assert (res.gene_states == GeneState.PARTIAL.value).any()


def test_missing_gene_untypeable_below_completeness(db_and_truth):
    db, truth, rng = db_and_truth
    # Keep only the first 2 of 6 genes from KL5 -> completeness 1/3 < 0.5 -> untypeable
    genes = truth["loci"]["KL5"]["genes"]
    locus = truth["loci"]["KL5"]["seq"]
    kept = locus[: genes[1][2] + 20] + locus[-80:]
    ga = _assembly_from({"c1": random_dna(rng, 3000) + kept + random_dna(rng, 3000)})
    res = Serotyper(db)(ga)
    assert res.best_locus_name == "KL5"
    assert not res.typeable
    assert len(res.missing_expected_genes) >= 3
    assert SerotypingProblem.MISSING_GENES in res.problems


def test_phenotype_extra_gene_rule(db_and_truth):
    db, truth, rng = db_and_truth
    # KL1 + the wcaJ extra gene present -> phenotype rule 'K1-like' fires
    locus = truth["loci"]["KL1"]["seq"]
    extra = truth["extra"]["wcaJ"]
    contig = random_dna(rng, 3000) + locus + random_dna(rng, 1500) + extra + random_dna(rng, 1500)
    res = Serotyper(db)(_assembly_from({"c1": contig}))
    assert res.best_locus_name == "KL1"
    assert res.phenotype == "K1-like"


def test_no_locus_untypeable(db_and_truth):
    db, truth, rng = db_and_truth
    ga = _assembly_from({"c1": random_dna(rng, 30000)})
    res = Serotyper(db)(ga)
    assert not res.typeable
    assert res.best_locus_completeness == 0.0
    assert res.percent_coverage == 0.0


def test_result_json_roundtrip(db_and_truth):
    db, truth, rng = db_and_truth
    locus = truth["loci"]["KL2"]["seq"]
    ga = _assembly_from({"c1": random_dna(rng, 2000) + locus + random_dna(rng, 2000)})
    res = Serotyper(db)(ga)

    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.integer, np.floating, np.bool_)):
            return o.item()
        if isinstance(o, SerotypingProblem):
            return int(o)
        raise TypeError(type(o))

    blob = json.dumps(res.to_dict(), default=default)
    res2 = SerotypingResult.from_dict(json.loads(blob))
    assert res2.best_locus_name == res.best_locus_name
    assert res2.phenotype == res.phenotype
    assert res2.typeable == res.typeable
    assert res2.problems == res.problems
    np.testing.assert_array_equal(res2.gene_states, res.gene_states)
    np.testing.assert_array_equal(res2.gene_hits.gene_indices, res.gene_hits.gene_indices)
    assert res2.locus_seqs.to_fasta() == res.locus_seqs.to_fasta()

    # TSV rows render from both original and round-tripped results identically
    assert bytes(KaptiveRow.from_result(res)) == bytes(KaptiveRow.from_result(res2))
    assert bytes(Pha4geRow.from_result(res)) == bytes(Pha4geRow.from_result(res2))


def test_kaptive_row_format(db_and_truth):
    db, truth, rng = db_and_truth
    locus = truth["loci"]["KL3"]["seq"]
    ga = _assembly_from({"c1": random_dna(rng, 2000) + locus + random_dna(rng, 2000)}, name="g1")
    res = Serotyper(db)(ga)
    row = KaptiveRow.from_result(res)
    header = KaptiveRow.header()
    assert header.startswith(b"Kaptive version\tDatabase name\t")
    assert b", details" in header
    line = bytes(row)
    cols = line.rstrip(b"\n").split(b"\t")
    assert len(cols) == 22
    assert cols[3] == b"g1"
    assert cols[4] == b"KL3"
    assert cols[6] == b"Typeable"
    assert cols[8].endswith(b"%")
    # Round-trip through read_tsv
    parsed = list(KaptiveRow.read_tsv([header, line]))
    assert len(parsed) == 1
    assert parsed[0].Best_match_locus == b"KL3"
