"""Multi-device sharding tests on the virtual 8-CPU mesh.

Sharded results must equal single-device results (SURVEY.md §4's strategy for
testing multi-node behaviour without a cluster).
"""

import io

import numpy as np
import pytest

import jax

from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.db import Database
from kaptive_tpu.parallel import make_mesh, locus_screen_batch, sharded_locus_screen
from kaptive_tpu.parallel.screen import ScreenTables, encode_assemblies_to_batch
from synthetic import make_genome_from_locus, make_synthetic_db


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("par_db")
    gbk, truth = make_synthetic_db(tmp, rng, n_loci=6, genes_per_locus=5)
    db = Database.from_genbank(gbk)
    # 8 assemblies, one per device, with known true loci
    true_loci = ["KL1", "KL2", "KL3", "KL4", "KL5", "KL6", "KL2", "KL4"]
    assemblies = []
    for i, ln in enumerate(true_loci):
        fasta = make_genome_from_locus(rng, truth, ln, flank=1500)
        assemblies.append(GenomeAssembly.from_stream(io.BytesIO(fasta), f"g{i}"))
    return db, assemblies, true_loci


def test_cpu_mesh_available():
    cpus = jax.devices("cpu")
    assert len(cpus) >= 8, "conftest must force an 8-device CPU mesh"


def test_screen_single_device(setup):
    db, assemblies, true_loci = setup
    tables = ScreenTables.from_database(db)
    codes = encode_assemblies_to_batch(assemblies)
    import jax.numpy as jnp

    best, scores = locus_screen_batch(
        jnp.asarray(codes),
        jnp.asarray(tables.table_hashes),
        jnp.asarray(tables.table_genes),
        jnp.asarray(tables.gene_locus_onehot),
        jnp.asarray(tables.expected_per_locus),
        jnp.asarray(tables.gene_minimizer_counts),
        n_genes=tables.gene_locus_onehot.shape[0],
    )
    called = [db.loci.ids[int(b)] for b in np.asarray(best)]
    assert called == true_loci


@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_sharded_screen_matches_single(setup, model_parallel):
    db, assemblies, true_loci = setup
    tables = ScreenTables.from_database(db)
    codes = encode_assemblies_to_batch(assemblies)
    import jax.numpy as jnp

    single_best, single_scores = locus_screen_batch(
        jnp.asarray(codes),
        jnp.asarray(tables.table_hashes),
        jnp.asarray(tables.table_genes),
        jnp.asarray(tables.gene_locus_onehot),
        jnp.asarray(tables.expected_per_locus),
        jnp.asarray(tables.gene_minimizer_counts),
        n_genes=tables.gene_locus_onehot.shape[0],
    )

    mesh = make_mesh(8, model_parallel=model_parallel, devices=jax.devices("cpu"))
    best, scores = sharded_locus_screen(mesh, codes, tables)
    np.testing.assert_array_equal(np.asarray(best), np.asarray(single_best))
    np.testing.assert_allclose(np.asarray(scores), np.asarray(single_scores), rtol=1e-6)


def test_screen_agrees_with_serotyper(setup):
    db, assemblies, true_loci = setup
    from kaptive_tpu.serotyping import Serotyper

    serotyper = Serotyper(db)
    tables = ScreenTables.from_database(db)
    codes = encode_assemblies_to_batch(assemblies[:3])
    import jax.numpy as jnp

    best, _ = locus_screen_batch(
        jnp.asarray(codes),
        jnp.asarray(tables.table_hashes),
        jnp.asarray(tables.table_genes),
        jnp.asarray(tables.gene_locus_onehot),
        jnp.asarray(tables.expected_per_locus),
        jnp.asarray(tables.gene_minimizer_counts),
        n_genes=tables.gene_locus_onehot.shape[0],
    )
    for i in range(3):
        full = serotyper(assemblies[i])
        assert db.loci.ids[int(best[i])] == full.best_locus_name


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_full_pipeline_sharded_equals_single(setup, mesh_shape):
    """The REAL typing pipeline under shard_map must reproduce single-device
    results exactly: best locus, gene states, and full KaptiveRow TSV bytes
    (SURVEY.md §2.3 contract: merged scores equal the single-device result)."""
    from kaptive_tpu.serotyping import Serotyper
    from kaptive_tpu.serotyping.io import KaptiveRow

    db, assemblies, true_loci = setup
    data, model = mesh_shape
    mesh = make_mesh(data * model, model_parallel=model, devices=jax.devices("cpu"))

    single = Serotyper(db).batch(assemblies)
    sharded = Serotyper(db, mesh=mesh).batch(assemblies)
    for s, m, ln in zip(single, sharded, true_loci):
        assert m.best_locus_name == ln
        np.testing.assert_array_equal(s.gene_states, m.gene_states)
        assert bytes(KaptiveRow.from_result(s)) == bytes(KaptiveRow.from_result(m))


def test_sharded_pipeline_uneven_batch(setup):
    """Batches that don't divide the data axis pad with empty streams."""
    from kaptive_tpu.serotyping import Serotyper

    db, assemblies, true_loci = setup
    mesh = make_mesh(8, model_parallel=2, devices=jax.devices("cpu"))
    results = Serotyper(db, mesh=mesh).batch(assemblies[:3])
    assert [r.best_locus_name for r in results] == true_loci[:3]


def test_serotyper_screen_method(setup):
    """Serotyper.screen (the production entry for the jitted screen) agrees
    with truth on every assembly."""
    from kaptive_tpu.serotyping import Serotyper

    db, assemblies, true_loci = setup
    ser = Serotyper(db)
    out_assemblies, best, weighted = ser.screen(assemblies)
    assert [db.loci.ids[b] for b in best] == true_loci
    assert weighted.shape == (len(assemblies), len(db.loci))
    for i, b in enumerate(best):
        assert weighted[i, b] == weighted[i].max() > 0
