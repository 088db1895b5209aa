"""Byte-level SVG snapshots for the plotting layer.

The TSV/JSONL outputs are regression-locked by the golden suite; these tests
do the same for the visual layer: the serotyping locus diagram and the
multi-locus synteny plot render from a seeded fixture and must match the
committed SVG byte-for-byte.  Regenerate intentionally with
``KAPTIVE_UPDATE_SNAPSHOTS=1 python -m pytest tests/test_plot_snapshots.py``.
"""

import io
import os
from pathlib import Path

import numpy as np
import pytest

from synthetic import make_genome_from_locus, make_synthetic_db

SNAP_DIR = Path(__file__).parent / "fixtures" / "plots"


@pytest.fixture(scope="module")
def fixture():
    import tempfile

    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.db import Database
    from kaptive_tpu.serotyping import Serotyper

    rng = np.random.default_rng(260821)
    tmp = Path(tempfile.mkdtemp())
    gbk, truth = make_synthetic_db(
        tmp, rng, n_loci=3, genes_per_locus=4, name="SnapDB", keyword="snap_db"
    )
    db = Database.from_genbank(gbk)
    fasta = make_genome_from_locus(rng, truth, "KL2", flank=4000)
    res = Serotyper(db)(GenomeAssembly.from_stream(io.BytesIO(fasta), "snapshot"))
    return db, res


def _check_snapshot(name: str, svg: str) -> None:
    path = SNAP_DIR / name
    if os.environ.get("KAPTIVE_UPDATE_SNAPSHOTS"):
        SNAP_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(svg)
        pytest.skip(f"snapshot {name} regenerated")
    assert path.exists(), (
        f"missing snapshot {path}; run with KAPTIVE_UPDATE_SNAPSHOTS=1 to create"
    )
    assert svg == path.read_text(), (
        f"{name} drifted from its committed snapshot — if the change is "
        f"intentional, regenerate with KAPTIVE_UPDATE_SNAPSHOTS=1"
    )


def test_serotyping_result_plot_snapshot(fixture):
    from kaptive_tpu.plotting import SerotypingResultPlotter

    _, res = fixture
    _check_snapshot("serotyping_result.svg", SerotypingResultPlotter()(res).to_svg())


def test_locus_comparison_plot_snapshot(fixture):
    from kaptive_tpu.compare import LocusComparator
    from kaptive_tpu.plotting import LocusComparisonPlotter

    db, _ = fixture
    comp = LocusComparator()([db.get_locus_data(n) for n in ("KL1", "KL2", "KL3")])
    _check_snapshot("locus_comparison.svg", LocusComparisonPlotter()(comp).to_svg())
