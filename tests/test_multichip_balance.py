"""Multi-device work-partition balance at bench-scale DB.

Correctness of the sharded pipeline is already bit-asserted
(tests/test_parallel.py, MULTICHIP dryrun); what was missing is evidence that
the partition is BALANCED — that the model-axis hash-range cuts and the
data/pair-axis splits give near-uniform per-device work at the 140-locus /
~2.5k-gene scale the bench runs.  Wall-clock on a virtual CPU mesh says
nothing, so this measures the work QUANTITIES each device would own:

- model axis: per-shard table entries and, for a panel of realistic genomes,
  per-shard matched-anchor counts (the match stage's gather work);
- data axis: per-device summed anchor counts for a round-robin batch split;
- DP pair axis: per-device pair counts under the lattice batch quantisation.

Asserts no device holds more than 1.5x the mean work on any axis, and writes
the measured numbers to MULTICHIP_BALANCE.md for the record.
"""

from pathlib import Path

import numpy as np
import pytest

from synthetic import make_synthetic_db, mutate_dna, random_dna

REPORT = Path(__file__).parent.parent / "MULTICHIP_BALANCE.md"


@pytest.fixture(scope="module")
def bench_scale_db(tmp_path_factory):
    from kaptive_tpu.db import Database

    rng = np.random.default_rng(140140)
    tmp = tmp_path_factory.mktemp("balancedb")
    gbk, truth = make_synthetic_db(
        tmp, rng, n_loci=140, genes_per_locus=18, name="BalanceDB", keyword="balance_db"
    )
    return Database.from_genbank(gbk), truth, rng


def _panel_minimizer_sets(db, truth, rng, n_genomes=8, genome_mb=1.0):
    """Minimizer hash arrays for a mixed panel (clean/diverged/fragmented)."""
    import io

    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.ops.minimizer import ContigIndex

    names = list(truth["loci"].keys())
    out = []
    for i in range(n_genomes):
        locus = truth["loci"][names[rng.integers(0, len(names))]]["seq"]
        if i % 2:
            locus = mutate_dna(rng, locus, sub_rate=0.01)
        flank = max(int(genome_mb * 1e6) - len(locus), 2000) // 2
        contig = random_dna(rng, flank) + locus + random_dna(rng, flank)
        ga = GenomeAssembly.from_stream(io.BytesIO(b">c1\n%s\n" % contig), f"bal{i}")
        out.append(ContigIndex.build(ga.contigs).minimizers.hashes)
    return out


def _per_shard_anchor_counts(table_hashes, cuts, genome_hashes, max_occ=1024):
    """Matched table entries per shard for one genome's minimizers (the
    quantity the match stage's expansion work scales with)."""
    lo = np.searchsorted(table_hashes, genome_hashes, side="left")
    hi = np.searchsorted(table_hashes, genome_hashes, side="right")
    occ = np.minimum(hi - lo, max_occ)
    matched = occ > 0
    # runs never straddle cuts (shard_cuts aligns them), so the run start
    # identifies the owning shard
    shard = np.searchsorted(cuts, lo[matched], side="right") - 1
    counts = np.zeros(len(cuts) - 1, dtype=np.int64)
    np.add.at(counts, shard, occ[matched])
    return counts


def test_partition_balance_bench_scale(bench_scale_db):
    from kaptive_tpu.parallel.typing import shard_cuts

    db, truth, rng = bench_scale_db
    gi = db.gene_index
    h = gi.minimizers.hashes
    panel = _panel_minimizer_sets(db, truth, rng)

    lines = [
        "# MULTICHIP balance report (work-partition proof)",
        "",
        f"Bench-scale DB: {len(db.loci)} loci / {len(db.genes)} genes / "
        f"{len(h)} table minimizers; panel: {len(panel)} mixed genomes.",
        "",
        "Evidence class: work quantities per device (wall-clock on a virtual",
        "CPU mesh is meaningless).  Bound asserted everywhere: max <= 1.5x mean.",
        "",
    ]

    # --- model axis: table entries + matched anchors per hash-range shard.
    for model in (2, 4, 8, 16):
        cuts = shard_cuts(h, model)
        entries = np.diff(cuts)
        anchors = np.sum(
            [_per_shard_anchor_counts(h, cuts, g) for g in panel], axis=0
        )
        for label, counts in (("table entries", entries), ("matched anchors", anchors)):
            mean = counts.mean()
            ratio = counts.max() / max(mean, 1e-9)
            lines.append(
                f"- model={model}: {label} per shard min={counts.min()} "
                f"max={counts.max()} mean={mean:.0f} -> max/mean {ratio:.3f}"
            )
            assert ratio <= 1.5, (model, label, counts)

    # --- data axis: summed anchor work per device for a round-robin split.
    total_per_genome = np.array(
        [_per_shard_anchor_counts(h, [0, len(h)], g)[0] for g in panel]
    )
    for data in (2, 4, 8):
        per_dev = np.array(
            [total_per_genome[d::data].sum() for d in range(data)], dtype=np.float64
        )
        ratio = per_dev.max() / max(per_dev.mean(), 1e-9)
        lines.append(
            f"- data={data}: per-device anchor work {per_dev.astype(int).tolist()} "
            f"-> max/mean {ratio:.3f}"
        )
        assert ratio <= 1.5, (data, per_dev)

    # --- DP pair axis: lattice batches shard evenly by construction; show it.
    from kaptive_tpu.ops.swg import plan_swg_buckets
    from kaptive_tpu.serotyping import Serotyper

    s = Serotyper(db)
    joint = rng.integers(60, int(db.translations.lengths.max()), 700)
    w_needed = rng.integers(40, 500, 700)
    for n_dev in (4, 8):
        min_batch = -(-16 // n_dev) * n_dev
        groups = plan_swg_buckets(
            joint, w_needed, s._protein_lattice, min_batch=min_batch
        )
        for _, rows, w, b_pad in groups:
            assert b_pad % n_dev == 0, (rows, w, b_pad, n_dev)
        lines.append(
            f"- pairs n_dev={n_dev}: every dispatch batch divisible by device "
            f"count ({[(g[3]) for g in groups]} pair slots across "
            f"{len(groups)} launches) -> per-device slots exactly equal"
        )

    REPORT.write_text("\n".join(lines) + "\n")


def test_shard_cuts_never_split_runs(bench_scale_db):
    from kaptive_tpu.parallel.typing import shard_cuts

    db, _, _ = bench_scale_db
    h = db.gene_index.minimizers.hashes
    for model in (2, 3, 8, 16):
        cuts = shard_cuts(h, model)
        assert cuts[0] == 0 and cuts[-1] == len(h)
        for c in cuts[1:-1]:
            if 0 < c < len(h):
                assert h[c] != h[c - 1], "cut splits a hash run"
