"""Benchmark: assemblies typed per second on one GPU (KpSC-K-scale workload).

Builds a synthetic database at kpsc_k scale (~140 loci x ~18 genes, genes
0.2-2.5 kb) and synthetic 5.3 Mb assemblies each containing one locus, in a
realistic composition mix — clean single-contig, 1%-diverged, fragmented
(locus split across contigs) and draft-quality (0.5% subs, ~24 contigs) —
then times the full typing pipeline (FASTA-equivalent ingest -> device
minimizer mapping -> scoring -> reconstruction -> protein DP -> phenotype ->
result) end to end.

Baseline anchor: reference Kaptive 3 is CPU-only and its Rust deps are not
installable here; its paper claims "thousands of assemblies on a desktop
computer" for batch runs, i.e. order 1 assembly/sec/machine
(/root/reference/README.md:61).  ``vs_baseline`` is measured throughput over
that 1.0 asm/s anchor (the generous-to-the-reference reading).

The benchmark needs a GPU: it exits non-zero when JAX's first device is not
one, and prints the card's name and power limit beside its number.

Correctness evidence per run: every timed pass checks the best-locus call of
all assemblies against truth, and after timing a sampled subset (one per
composition class) is verified to the full 22-column KaptiveRow byte level
against the in-process REFERENCE engine consuming our mapper's hits
(tests/ref_oracle.py; skipped when /root/reference is absent).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
``value`` is the MEDIAN of the timed passes (every pass time prints, so the
spread is visible).
"""

import json
import os
import pickle
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent / "tests"))

import numpy as np
from synthetic import ASSEMBLY_KINDS

CACHE = Path(os.environ.get("KAPTIVE_TPU_BENCH_CACHE", Path(__file__).parent / "build" / "bench"))
N_ASSEMBLIES = int(os.environ.get("KAPTIVE_TPU_BENCH_N", "32"))
GENOME_MB = 5.3
BASELINE_ASM_PER_SEC = 1.0


def build_fixtures():
    from synthetic import compose_assembly, make_synthetic_db

    from kaptive_tpu.db import Database

    CACHE.mkdir(parents=True, exist_ok=True)
    db_pkl = CACHE / "bench_db.pkl"
    asm_pkl = CACHE / f"bench_assemblies_v2_{N_ASSEMBLIES}.pkl"
    rng = np.random.default_rng(2026)
    if db_pkl.exists() and asm_pkl.exists():
        db = Database.from_pickle(db_pkl)
        with asm_pkl.open("rb") as fh:
            assemblies = pickle.load(fh)
        return db, assemblies

    gbk, truth = make_synthetic_db(
        CACHE, rng, n_loci=140, genes_per_locus=18, name="BenchDB", keyword="bench_db"
    )
    db = Database.from_genbank(gbk)
    db.save(db_pkl)

    locus_names = list(truth["loci"].keys())
    assemblies = []
    flank = int(GENOME_MB * 1e6 / 2)
    for i in range(N_ASSEMBLIES):
        ln = locus_names[rng.integers(0, len(locus_names))]
        kind = ASSEMBLY_KINDS[i % len(ASSEMBLY_KINDS)]
        fasta = compose_assembly(rng, kind, truth["loci"][ln]["seq"], flank)
        assemblies.append((f"asm{i}", ln, kind, fasta))
    with asm_pkl.open("wb") as fh:
        pickle.dump(assemblies, fh)
    return db, assemblies


def _normalise_row(row: bytes) -> bytes:
    cols = row.split(b"\t")
    cols[0] = b"<version>"  # version column differs by construction
    return b"\t".join(cols)


def verify_rows(db, serotyper, assemblies, sample_idx) -> tuple[int, int]:
    """Full KaptiveRow byte verification vs the in-process reference engine.

    Runs outside the timed passes; returns (verified, attempted).  Uses the
    same oracle harness as tests/test_golden_ref.py: the reference decision
    layers consume OUR mapper's hits, so every downstream byte must agree.
    """
    import io

    try:
        from ref_oracle import (
            reference_available,
            reference_row_bytes,
            reference_serotype,
        )
    except ImportError:
        return 0, 0
    if not reference_available():
        return 0, 0
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.serotyping.io import KaptiveRow

    ok = 0
    for i in sample_idx:
        name, _, kind, fasta = assemblies[i]
        ga = GenomeAssembly.from_stream(io.BytesIO(fasta), name)
        # One device mapping pass feeds BOTH engines (mapping is the
        # expensive stage; rerunning it per engine would double the cost).
        [ga], [alns] = serotyper.map_batch([ga])
        [ours] = serotyper.finish_batch([ga], [alns])
        if ours is None:
            print(f"# ROW UNVERIFIABLE: {name} ({kind}) typed to None", file=sys.stderr)
            continue
        ref = reference_serotype(db, ga, alns)
        ours_row = _normalise_row(bytes(KaptiveRow.from_result(ours)))
        ref_row = _normalise_row(reference_row_bytes(ref))
        if ours_row == ref_row:
            ok += 1
        else:
            print(f"# ROW MISMATCH on {name} ({kind})", file=sys.stderr)
    return ok, len(sample_idx)


def main() -> None:
    import io
    import subprocess

    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's first device is {device}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# card: {card}", file=sys.stderr, flush=True)
    os.environ.setdefault("KAPTIVE_PROFILE", "1")  # bench always reports the phase table

    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.serotyping import Serotyper

    from kaptive_tpu.utils.metrics import metrics_report, reset_metrics
    from kaptive_tpu.utils.profiling import phase_report, reset_phases

    db, assemblies = build_fixtures()
    serotyper = Serotyper(db)

    # 32/batch: fewer batch boundaries and better DP-bucket fill than 16; scan
    # still runs in fixed 8-genome chunks so compiled shapes are unchanged.
    batch_size = int(os.environ.get("KAPTIVE_TPU_BENCH_BATCH", "32"))

    # Warm-up: compiles the device kernels (minimizer scan, SWG lattice
    # shapes, decision jits) — Serotyper.warmup() covers every shape the
    # frozen lattices can dispatch, plus one real-composition batch so the
    # scan/match/chain programs for this genome size class compile too.
    print("# warm-up (compiles device programs)...", file=sys.stderr, flush=True)
    t_w = time.perf_counter()
    serotyper.warmup(genome_length=int(GENOME_MB * 1e6), batch_size=batch_size)
    warm = [
        GenomeAssembly.from_stream(io.BytesIO(assemblies[i][3]), f"warm{i}")
        for i in range(min(batch_size, len(assemblies)))
    ]
    res = serotyper.batch(warm)
    assert res[0] is not None
    print(f"# warm-up done in {time.perf_counter() - t_w:.1f}s", file=sys.stderr, flush=True)
    metrics_report()  # which impls/shapes the warm-up compiled
    reset_phases()  # warm-up compile time must not pollute the phase table
    reset_metrics(keep_shapes=True)  # a timed-run new_shape => steady-state compile

    # Timed run uses the production streaming path: host ingest threads
    # prefetch the next batch while the device types the current one.  The
    # stream is timed KAPTIVE_TPU_BENCH_PASSES times (default 5) and the MEDIAN
    # pass reported; every pass time prints.
    from kaptive_tpu.parallel.pipeline import stream_type

    truth = [t for _, t, _, _ in assemblies]

    def timed_pass():
        streams = [io.BytesIO(fasta) for _, _, _, fasta in assemblies]
        correct = 0
        done = 0
        t0 = time.perf_counter()
        for r in stream_type(serotyper, streams, batch_size=batch_size):
            if r.best_locus_name == truth[done]:
                correct += 1
            done += 1
        return time.perf_counter() - t0, correct

    # One untimed priming pass: the first stream through a fresh process pays
    # one-off costs (persistent-cache writes, first-touch transfer setup,
    # allocator growth) that are not steady-state throughput; every timed
    # pass thereafter does the full ingest+type work from scratch.
    elapsed, correct = timed_pass()
    print(f"# priming pass (untimed): {elapsed:.2f}s, {correct}/{len(assemblies)} correct",
          file=sys.stderr, flush=True)

    passes = []
    n_passes = int(os.environ.get("KAPTIVE_TPU_BENCH_PASSES", "5"))
    for p in range(n_passes):
        reset_phases()
        elapsed, correct = timed_pass()
        passes.append((elapsed, correct))
        print(f"# pass {p + 1}: {elapsed:.2f}s, {correct}/{len(assemblies)} correct",
              file=sys.stderr, flush=True)
    phase_report()  # where the time of the LAST pass went
    metrics_report()  # fallback/impl/shape counters: proves which path ran

    elapsed = statistics.median(e for e, _ in passes)
    correct = min(c for _, c in passes)
    value = len(assemblies) / elapsed

    # Ingest headroom: pure host-side parse+encode+pack throughput (no H2D),
    # measured on the same pool width the stream uses.  This is the number
    # that says whether ingest can feed a faster device: it must exceed the
    # device throughput with margin.
    from concurrent.futures import ThreadPoolExecutor

    from kaptive_tpu.ops.minimizer import ContigIndex

    def _cpu_ingest(fasta: bytes) -> None:
        ga = GenomeAssembly.from_stream(io.BytesIO(fasta), "ingest_probe")
        ContigIndex.build(ga.contigs)

    with ThreadPoolExecutor(max_workers=16) as pool:
        t0 = time.perf_counter()
        list(pool.map(_cpu_ingest, [f for _, _, _, f in assemblies]))
        ingest_rate = len(assemblies) / (time.perf_counter() - t0)
    print(
        f"# ingest_cpu_capacity: {ingest_rate:.1f} asm/s on a 16-thread pool "
        f"({ingest_rate / max(value, 1e-9):.1f}x the end-to-end device throughput)",
        file=sys.stderr, flush=True,
    )

    # Row-level verification on one assembly per composition class (not timed).
    sample = [i for i in range(min(len(ASSEMBLY_KINDS), len(assemblies)))]
    rows_ok, rows_n = verify_rows(db, serotyper, assemblies, sample)
    print(f"# rows_verified: {rows_ok}/{rows_n}"
          + (" (reference oracle unavailable)" if rows_n == 0 else ""),
          file=sys.stderr, flush=True)

    print(
        json.dumps(
            {
                "metric": "assemblies_typed_per_sec",
                "device": {"platform": device.platform, "kind": device.device_kind,
                           "count": len(jax.devices()), "card": card},
                "value": round(value, 3),
                "unit": "assemblies/s",
                "vs_baseline": round(value / BASELINE_ASM_PER_SEC, 3),
                "rows_verified": f"{rows_ok}/{rows_n}",
                "passes_sec": [round(e, 2) for e, _ in passes],
            }
        )
    )
    print(
        f"# median of {len(passes)} passes: {len(assemblies)} x {GENOME_MB} Mb "
        f"assemblies ({'/'.join(ASSEMBLY_KINDS)} mix) in {elapsed:.2f}s on {card}; "
        f"accuracy {correct}/{len(assemblies)} correct locus calls",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
