"""Multi-locus comparison and synteny plotting tests.

Mirrors the coverage of ``/root/reference/tests/test_compare.py``: metadata
propagation, bytes decoding, shape validation errors; plus plot rendering.
"""

import numpy as np
import pytest

from kaptive_tpu.compare import LocusComparator, LocusData
from kaptive_tpu.core.interval import Intervals
from kaptive_tpu.core.seq import Sequences
from kaptive_tpu.db import Database
from kaptive_tpu.plotting import LocusComparisonPlotter, connected_components
from synthetic import make_synthetic_db


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    rng = np.random.default_rng(21)
    tmp = tmp_path_factory.mktemp("cmp_db")
    gbk, _ = make_synthetic_db(tmp, rng, n_loci=3, genes_per_locus=4)
    return Database.from_genbank(gbk)


def test_get_locus_data(db):
    data = db.get_locus_data("KL1")
    assert data.name == "KL1"
    assert len(data.proteins) == 4
    assert len(data.backbone) == 4
    assert len(data.gene_descriptions) == 4
    assert data.gene_descriptions[0].startswith("protein")
    with pytest.raises(ValueError):
        db.get_locus_data("NOPE")


def test_comparator_on_db_loci(db):
    inputs = [db.get_locus_data(n) for n in ("KL1", "KL2", "KL3")]
    comp = LocusComparator()(inputs)
    assert comp.locus_names == ("KL1", "KL2", "KL3")
    assert list(comp.locus_lengths) == [4, 4, 4]
    assert list(comp.locus_offsets) == [0, 4, 8]
    assert len(comp.gene_names) == 12
    assert len(comp.gene_intervals) == 12
    # Synthetic loci are random: few/no homology edges expected, but the
    # structure must be consistent
    e = comp.edges
    if len(e):
        assert (e.query_locus_indices < e.target_locus_indices).all()
        assert (e.global_query_indices < 12).all()


def test_comparator_detects_shared_genes(db):
    # Compare a locus against itself (as two inputs) -> every gene matches
    a = db.get_locus_data("KL1")
    b = db.get_locus_data("KL1")
    comp = LocusComparator()([LocusData(a.proteins, "copy1", a.backbone,
                                        gene_descriptions=a.gene_descriptions),
                              LocusData(b.proteins, "copy2", b.backbone,
                                        gene_descriptions=b.gene_descriptions)])
    e = comp.edges
    assert len(e) == 4  # one best hit per query protein
    np.testing.assert_array_equal(e.query_indices, e.target_indices)
    assert (e.alignments.pidents == 100.0).all()


def test_comparator_validation_errors(db):
    a = db.get_locus_data("KL1")
    bad_backbone = Intervals(
        np.array([0], dtype=np.int32), np.array([10], dtype=np.int32), np.array([1], dtype=np.int8)
    )
    with pytest.raises(ValueError, match="backbone length"):
        LocusComparator()([LocusData(a.proteins, "bad", bad_backbone)])
    with pytest.raises(ValueError, match="gene_descriptions length"):
        LocusComparator()([LocusData(a.proteins, "bad", a.backbone, gene_descriptions=["x"])])
    with pytest.raises(ValueError, match="gene_states length"):
        LocusComparator()(
            [LocusData(a.proteins, "bad", a.backbone, gene_states=np.zeros(1, dtype=np.int8))]
        )


def test_comparator_single_and_empty(db):
    a = db.get_locus_data("KL1")
    comp = LocusComparator()([a])
    assert len(comp.edges) == 0
    comp0 = LocusComparator()([])
    assert comp0.locus_names == ()


def test_comparison_plot(db, tmp_path):
    a = db.get_locus_data("KL1")
    comp = LocusComparator()([
        LocusData(a.proteins, "copy1", a.backbone, gene_descriptions=a.gene_descriptions),
        LocusData(a.proteins, "copy2", a.backbone, gene_descriptions=a.gene_descriptions),
    ])
    fig = LocusComparisonPlotter()(comp)
    out = tmp_path / "cmp.html"
    fig.write_html(out)
    content = out.read_text()
    assert content.startswith("<!DOCTYPE html>")
    assert "copy1" in content and "copy2" in content
    assert "polygon" in content and "path" in content  # glyphs + ribbons


def test_connected_components():
    comp = connected_components(6, np.array([0, 1, 4]), np.array([1, 2, 5]))
    assert comp[0] == comp[1] == comp[2]
    assert comp[3] not in (comp[0], comp[4])
    assert comp[4] == comp[5]
