"""Database compilation, metadata, phenotype masks, and manager cache tests.

Mirrors the coverage of ``/root/reference/tests/test_db.py`` (metadata semver,
manager registry, phenotype container, get_locus_data) plus a full GenBank+TOML
compile from synthetic fixtures.
"""

import numpy as np
import pytest

from kaptive_tpu.db import Database, DatabaseError, DatabaseManager, DatabaseMetadata, Phenotypes
from kaptive_tpu.db.genbank import iter_records, parse_location, write_genbank
from synthetic import make_synthetic_db


@pytest.fixture()
def rng():
    return np.random.default_rng(11)


def test_parse_location():
    assert (loc := parse_location("123..456")).start == 122 and loc.end == 456 and loc.strand == 1
    assert (loc := parse_location("complement(123..456)")).strand == -1
    assert (loc := parse_location("join(10..20,30..40)")).start == 9 and loc.end == 40
    assert (loc := parse_location("complement(join(10..20,30..40))")).strand == -1
    assert (loc := parse_location("<5..>10")).start == 4 and loc.end == 10
    assert (loc := parse_location("42")).start == 41 and loc.end == 42


def test_genbank_roundtrip(tmp_path, rng):
    gbk, truth = make_synthetic_db(tmp_path, rng)
    with gbk.open("rb") as fh:
        recs = list(iter_records(fh))
    assert len(recs) == 5  # 4 loci + Extra_genes
    assert recs[0].name == "KL1"
    assert recs[0].sequence == truth["loci"]["KL1"]["seq"]
    assert recs[0].features[0].kind == "source"
    notes = [q.value for q in recs[0].features[0].qualifiers if q.key == "note"]
    assert "locus: KL1" in notes and "type: K1" in notes
    cds = [f for f in recs[0].features if f.kind == "CDS"]
    assert len(cds) == 5
    # Strand alternation and coordinates match the ground truth
    for feat, (cluster, s, e, strand, orf) in zip(cds, truth["loci"]["KL1"]["genes"]):
        assert feat.location.start == s and feat.location.end == e and feat.location.strand == strand
        assert ("gene", cluster) in [tuple(q) for q in feat.qualifiers]


def test_db_compile(tmp_path, rng):
    gbk, truth = make_synthetic_db(tmp_path, rng)
    db = Database.from_genbank(gbk)
    assert db.metadata.keyword == "test_db"
    assert db.metadata.id_threshold == 82.5
    assert db.loci.ids == ("KL1", "KL2", "KL3", "KL4", "Extra_genes")
    assert db.serotypes[:4] == ("K1", "K2", "K3", "K4")
    assert len(db.genes) == 4 * 5 + 1
    assert db.extra_genes.sum() == 1
    assert db.gene_positions[-1] == 0  # extra gene: no expected position

    # Gene extraction: forward/reverse genes recover the original ORFs
    for li, locus_name in enumerate(("KL1", "KL2")):
        for gi, (cluster, s, e, strand, orf) in enumerate(truth["loci"][locus_name]["genes"]):
            g = int(db.locus_gene_offsets[li]) + gi
            assert db.genes[g].seq == orf, f"{locus_name} gene {gi}"
            assert db.genes.ids[g] == f"{locus_name}_{gi + 1:02}_{cluster}"
    # Translations start with M and have no stops (to_stop=False in compile, stop retained)
    prot = db.translations[0].seq
    assert prot.startswith(b"M") and prot.endswith(b"*")

    # Phenotype masks
    ph = db.phenotypes
    assert len(ph) == 2
    assert ph.ids[0] == b"K1-like"
    assert ph.locus_masks[0, 0] and not ph.locus_masks[0, 1]
    assert ph.extra_counts[0] == 1
    # wildcard inactive_genes 'wz*' expands to all wz clusters
    assert ph.inactive_masks[1].sum() == 5
    assert db.max_locus_length == int(db.loci.lengths.max())


def test_db_pickle_roundtrip(tmp_path, rng):
    gbk, _ = make_synthetic_db(tmp_path, rng)
    db = Database.from_genbank(gbk)
    pkl = tmp_path / "db.pkl"
    db.save(pkl)
    db2 = Database.load(pkl)
    assert db2.loci.ids == db.loci.ids
    np.testing.assert_array_equal(db2.genes.seqs, db.genes.seqs)
    assert db2.metadata.version == db.metadata.version


def test_db_manager_local(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("KAPTIVE_DB_DIR", str(tmp_path / "cache"))
    gbk, _ = make_synthetic_db(tmp_path, rng)
    # get() with a direct path compiles from GenBank
    db = DatabaseManager.get(gbk)
    assert db.metadata.keyword == "test_db"
    # save/load/installed/uninstall cycle
    DatabaseManager.save(db)
    assert "test_db" in DatabaseManager.installed()
    db2 = DatabaseManager.load("test_db")
    assert db2.loci.ids == db.loci.ids
    DatabaseManager.uninstall("test_db")
    assert "test_db" not in DatabaseManager.installed()
    with pytest.raises(DatabaseError):
        DatabaseManager.load("test_db")
    assert set(DatabaseManager.known()) >= {"kpsc_k", "kpsc_o", "ab_k"}


def test_metadata_semver():
    data = dict(
        name="x", keyword="x", genbank="x.gbk", organism="o", taxon=1, antigen="a",
        pathway="p", version="3.10.2", id_threshold=80.0, doi=[], owner="o", repo="r",
        branch="main", contact={},
    )
    meta = DatabaseMetadata.from_dict(data)
    assert meta.parsed_version == (3, 10, 2)
    assert meta.parsed_version > DatabaseMetadata.from_dict({**data, "version": "3.9.9"}).parsed_version
    with pytest.raises(DatabaseError):
        DatabaseMetadata.from_dict({k: v for k, v in data.items() if k != "name"})
    with pytest.raises(DatabaseError):
        DatabaseMetadata.from_dict("not a dict")


def test_metadata_restores_legacy_pickle_states():
    """Caches written by the former frozen-slotted-dataclass DatabaseMetadata
    pickle their state as a positional list of field values (CPython 3.12
    ``_dataclass_getstate``); restoring one must yield working attributes."""
    legacy_values = [
        "LegacyDB", "legacy", "x.gbk", "Testus", 5, "CPS", "Wzy", "2.1.0",
        82.5, ["10.1/x"], "own", "rep", "main", {"T": "t@e.org"}, {}, {},
    ]
    meta = DatabaseMetadata.__new__(DatabaseMetadata)
    meta.__setstate__(legacy_values)
    assert meta.name == "LegacyDB" and meta.taxon == 5
    assert meta.parsed_version == (2, 1, 0)
    assert meta.antigenic_units == {}
    # Generic slotted two-tuple form also restores.
    meta2 = DatabaseMetadata.__new__(DatabaseMetadata)
    meta2.__setstate__((None, {"name": "X", "version": "1.0"}))
    assert meta2.name == "X"
    # And a modern mapping state round-trips through pickle itself.
    import pickle

    data = dict(
        name="x", keyword="x", genbank="x.gbk", organism="o", taxon=1, antigen="a",
        pathway="p", version="3.10.2", id_threshold=80.0, doi=[], owner="o", repo="r",
        branch="main", contact={},
    )
    meta3 = pickle.loads(pickle.dumps(DatabaseMetadata.from_dict(data)))
    assert meta3.version == "3.10.2" and meta3.keyword == "x"


def test_missing_toml_raises(tmp_path, rng):
    gbk, _ = make_synthetic_db(tmp_path, rng)
    gbk.with_suffix(".toml").unlink()
    with pytest.raises(DatabaseError, match="TOML"):
        Database.from_genbank(gbk)


def test_phenotypes_container():
    ph = Phenotypes.empty()
    assert len(ph) == 0
    assert len(Phenotypes.concat([])) == 0
    one = Phenotypes(
        np.array([b"a"], dtype="S32"), np.zeros((1, 1), bool), np.zeros((1, 1), np.int8),
        np.zeros((1, 1), np.int8), np.zeros(1, np.int8), np.zeros(1, np.int8),
        np.zeros(1, bool),
    )
    # Integer indexing yields a one-row view (uniform SoAContainer semantics).
    row = one[0]
    assert isinstance(row, Phenotypes) and len(row) == 1
    assert row.locus_masks.shape == (1, 1)
    with pytest.raises(IndexError):
        one[3]


def test_genbank_wrapped_qualifier_with_slash_continuation():
    """A wrapped quoted value whose continuation line begins with '/' must keep
    accumulating — not truncate the value and fabricate a bogus qualifier."""
    import io

    from kaptive_tpu.db.genbank import iter_records

    gbk = (
        b"LOCUS       TESTREC                 12 bp    DNA     linear   BCT 01-JAN-2026\n"
        b"FEATURES             Location/Qualifiers\n"
        b"     source          1..12\n"
        b'                     /note="a long note that wraps onto\n'
        b'                     /another line starting with slash"\n'
        b'                     /organism="Testus"\n'
        b"ORIGIN\n"
        b"        1 acgtacgtac gt\n"
        b"//\n"
    )
    (rec,) = iter_records(io.BytesIO(gbk))
    quals = {q.key: q.value for q in rec.features[0].qualifiers}
    assert quals["note"] == "a long note that wraps onto /another line starting with slash"
    assert quals["organism"] == "Testus"
    assert len(rec.features[0].qualifiers) == 2
