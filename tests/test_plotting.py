"""Plot geometry + interaction-layer tests (parity-spirited with the
reference's ``tests/test_plotting.py:47-69`` glyph/hover assertions).

The figures are dependency-free SVG/HTML with an inline viewBox zoom/pan
controller, legend click-toggles and data-tip tooltips — these tests pin the
glyph vertex geometry, the hover/legend content, and the presence and wiring
of the interaction layer.
"""

import io
import tempfile
from pathlib import Path

import numpy as np
import pytest

from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.db import Database
from kaptive_tpu.plotting import (
    Figure,
    GeneStyleManager,
    LocusComparisonPlotter,
    SerotypingResultPlotter,
    gene_arrow_points,
)
from kaptive_tpu.serotyping import Serotyper
from synthetic import make_genome_from_locus, make_synthetic_db


@pytest.fixture(scope="module")
def result_and_db():
    rng = np.random.default_rng(99)
    tmp = Path(tempfile.mkdtemp())
    gbk, truth = make_synthetic_db(tmp, rng, n_loci=3, genes_per_locus=4)
    db = Database.from_genbank(gbk)
    fasta = make_genome_from_locus(rng, truth, "KL2", flank=4000)
    res = Serotyper(db)(GenomeAssembly.from_stream(io.BytesIO(fasta), "plotme"))
    return res, db


def test_gene_arrow_vertex_geometry():
    # Forward arrow: flat tail at x0, head apex exactly at x1 on the midline.
    pts = gene_arrow_points(10.0, 110.0, 50.0, 20.0, strand=1, head=8.0)
    vertices = [tuple(map(float, p.split(","))) for p in pts.split()]
    assert vertices == [
        (10.0, 40.0), (102.0, 40.0), (110.0, 50.0), (102.0, 60.0), (10.0, 60.0)
    ]
    # Reverse arrow mirrors: apex at x0.
    pts_r = gene_arrow_points(10.0, 110.0, 50.0, 20.0, strand=-1, head=8.0)
    vr = [tuple(map(float, p.split(","))) for p in pts_r.split()]
    assert vr[2] == (10.0, 50.0) and vr[0] == (110.0, 40.0)
    # Head clamps to the glyph width for tiny genes (no inverted polygons).
    tiny = gene_arrow_points(10.0, 14.0, 50.0, 20.0, strand=1, head=8.0)
    xs = [float(p.split(",")[0]) for p in tiny.split()]
    assert min(xs) >= 10.0 and max(xs) <= 14.0


def test_result_plot_glyphs_and_hover(result_and_db):
    res, _ = result_and_db
    fig = SerotypingResultPlotter()(res)
    svg = fig.to_svg()
    n_inside = int(np.sum(res.gene_hits.is_inside))
    assert svg.count('<polygon class="gene') == n_inside
    # Hover content carries gene id, state, identity and coverage per glyph.
    gid = res.gene_hits.gene_ids[0].decode()
    assert gid in svg and "identity" in svg and "coverage" in svg
    # State classes drive the legend toggles.
    assert 'class="gene state-normal"' in svg
    for name in GeneStyleManager.STATE_NAMES.values():
        assert f'data-target="state-{name}"' in svg  # one legend entry per state


def test_html_interaction_layer(result_and_db, tmp_path):
    res, _ = result_and_db
    out = tmp_path / "plot.html"
    SerotypingResultPlotter()(res).write_html(out)
    page = out.read_text()
    # Zoom/pan/reset controller manipulating the SVG viewBox.
    assert "svg.viewBox.baseVal" in page
    assert "wheel" in page and "mousedown" in page and "dblclick" in page
    # Legend toggles and the floating tooltip div.
    assert "legend-item" in page and "data-tip" in page and "tip.style.left" in page
    # <title> fallbacks survive for scriptless viewing.
    assert "<title>" in page


def test_comparison_plot_ribbons(result_and_db):
    _, db = result_and_db
    from kaptive_tpu.compare import LocusComparator

    comp = LocusComparator()(
        [db.get_locus_data(n) for n in ("KL1", "KL2", "KL3")]
    )
    fig = LocusComparisonPlotter()(comp)
    svg = fig.to_svg()
    # One glyph per gene across all loci; ribbons only when homology exists.
    assert svg.count('<polygon class="gene"') == int(comp.locus_lengths.sum())
    assert 'data-target="ribbon"' in svg  # ribbon legend toggle present
    n_adjacent = int(
        np.sum(comp.edges.target_locus_indices == comp.edges.query_locus_indices + 1)
    )
    assert svg.count('<path class="ribbon"') == n_adjacent
    if n_adjacent:
        assert "% identity" in svg


def test_empty_result_plot():
    fig = Figure(title="t")
    assert "<svg" in fig.to_svg()
    html_page = fig.to_html()
    assert "scroll to zoom" in html_page
