#!/usr/bin/env python3
r"""Prove that kaptive-tpu runs on one NVIDIA GPU, through its normal entry points.

Phases (any failed check exits non-zero; the last stdout line is a JSON
object, printed only when every phase passed):

1. device     — JAX's first device must be a GPU; print the card's name and
                power limit, the JAX version and ``XLA_FLAGS``.
2. parity     — build the CUDA SWG library, then at every DP lattice shape the
                typing engine compiles (read from ``Serotyper``'s lattices) run
                database-derived pairs through the CUDA kernel and through
                XLA's lax path: all eight result fields must be equal, and a
                sample must equal the numpy oracle.  Both times per shape.
3. main path  — type a panel of synthetic 5.3 Mb assemblies against a
                KpSC-K-scale synthetic database (140 loci x 18 genes) through
                ``kaptive-tpu type`` called in-process, host-seeded, writing
                TSV and JSONL; every best-locus call must equal the truth.
                Wall time of the cold run (warm-up and compiles included), then
                WARM_PAIRS pairs of warm passes, CUDA and lax DP alternating
                within a pair: walls, DP phase times and pairs won (a smoke
                number, not a benchmark), and the pipeline counters.
4. seed modes — the same panel device-seeded; TSV rows must be byte-identical.

``--cards 4`` runs only the sharded path: ``Serotyper`` over a (data=2,
model=2) mesh of four GPUs must give rows byte-identical to the single-card
``Serotyper``, with every SWG dispatch of the sharded batch on the CUDA kernel.

Run from the repository root: ``python chip_smoke.py`` or
``python chip_smoke.py --cards 4``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "smoke"
N_LOCI, GENES_PER_LOCUS = 140, 18  # KpSC K-locus database scale
N_ASSEMBLIES, GENOME_MB = 16, 5.3  # the smoke panel: 16 Klebsiella-sized assemblies
SEED = 2026
ORACLE_SAMPLE = 2  # pairs per lattice shape checked against the numpy oracle
TIMING_REPS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# --- phase 1 ------------------------------------------------------------------------------------
def card_lines() -> list[str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return [f"card: {line.strip()}" for line in smi.stdout.strip().splitlines()]


def phase_device(n_cards: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's devices are {devices}", file=sys.stderr)
        raise SystemExit(2)
    check(len(devices) >= n_cards, f"need {n_cards} GPUs, JAX has {len(devices)}")
    for line in card_lines():
        log(line)
    log(f"jax {jax.__version__}; devices {devices}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return devices


# --- data -------------------------------------------------------------------------------------
def write_panel():
    r"""Synthetic database (GenBank+TOML) and assembly FASTA files under WORK."""
    import numpy as np
    from synthetic import ASSEMBLY_KINDS, compose_assembly, make_synthetic_db

    t0 = time.perf_counter()
    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    gbk, truth = make_synthetic_db(
        WORK, rng, n_loci=N_LOCI, genes_per_locus=GENES_PER_LOCUS,
        name="SmokeDB", keyword="smoke_db",
    )
    names = list(truth["loci"])
    flank = int(GENOME_MB * 1e6 / 2)
    panel = []
    for i in range(N_ASSEMBLIES):
        locus = names[int(rng.integers(len(names)))]
        kind = ASSEMBLY_KINDS[i % len(ASSEMBLY_KINDS)]
        path = WORK / f"asm{i:02d}.fasta"
        path.write_bytes(compose_assembly(rng, kind, truth["loci"][locus]["seq"], flank))
        panel.append((path, locus, kind))
    log(f"data: {N_LOCI} loci x {GENES_PER_LOCUS} genes; {N_ASSEMBLIES} assemblies of "
        f"{GENOME_MB} Mb ({'/'.join(ASSEMBLY_KINDS)}) in {time.perf_counter() - t0:.1f}s")
    return gbk, panel


# --- phase 2 ------------------------------------------------------------------------------------
def _mutate(rng, seq, alphabet: bytes, sub_rate: float):
    import numpy as np

    arr = np.frombuffer(seq, np.uint8).copy()
    hit = rng.random(len(arr)) < sub_rate
    arr[hit] = np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), int(hit.sum()))]
    return arr.tobytes()


def _protein_pairs(rng, db, rows: int, w_lo: int, w: int, b: int):
    r"""Unseeded protein pairs (hit translation vs DB protein) whose band
    ``2k+3``, k = max(20, |len diff| + 1), lands in ``(w_lo, w]``."""
    import numpy as np

    tr = db.translations
    k_lo = max(20, (w_lo - 3) // 2 + 1)
    k_hi = (w - 3) // 2
    d_lo = 0 if k_lo == 20 else k_lo - 1  # length difference giving k_lo
    cand = np.flatnonzero((tr.lengths >= d_lo + 10) & (tr.lengths <= rows))
    check(len(cand) > 0, f"no database protein fits a {w}-wide band at {rows} rows")
    pairs = []
    while len(pairs) < b:
        i = int(cand[rng.integers(len(cand))])
        q = tr.seqs[tr.offsets[i] : tr.offsets[i] + tr.lengths[i]].tobytes()
        diff = int(rng.integers(d_lo, min(k_hi - 1, len(q) - 10) + 1))
        t = _mutate(rng, q[: len(q) - diff], b"ARNDCQEGHILKMFPSTWYV", rng.uniform(0.02, 0.3))
        pairs.append((q, t, 0, max(20, abs(len(q) - len(t)) + 1)))
    return pairs


def _extension_pairs(rng, db, rows: int, rows_lo: int, w_lo: int, w: int, b: int):
    r"""Seeded gene-vs-contig-window pairs: the gene (mutated, with indels)
    embedded in random flanks, window length in ``(rows_lo, rows]``, band half
    width in the extension lattice's range for ``(w_lo, w]``."""
    import numpy as np
    from synthetic import mutate_dna, random_dna

    from kaptive_tpu.ops.minimizer import encode_dna

    genes = db.genes
    k_lo = max(48, (w_lo - 3) // 2 + 1)  # band_slack floor of the mapper
    k_hi = (w - 3) // 2
    pairs = []
    while len(pairs) < b:
        i = int(rng.integers(len(genes.lengths)))
        q = genes.seqs[genes.offsets[i] : genes.offsets[i] + genes.lengths[i]].tobytes()
        body = mutate_dna(rng, q, sub_rate=0.01, indel_rate=0.002)
        lo = max(rows_lo - len(body) + 1, 2 * 64)
        hi = rows - len(body)
        if lo > hi:
            continue
        span = int(rng.integers(lo, hi + 1))
        left = int(rng.integers(0, span + 1))
        t = random_dna(rng, left) + body + random_dna(rng, span - left)
        pairs.append((
            encode_dna(np.frombuffer(q, np.uint8)).tobytes(),  # the mapper's 2-bit codes
            encode_dna(np.frombuffer(t, np.uint8)).tobytes(),
            -left, int(rng.integers(k_lo, k_hi + 1)),
        ))
    return pairs


def _bucket(pairs, rows: int, w: int):
    import numpy as np

    b = len(pairs)
    t_pad = w + 2
    q_mat = np.zeros((b, rows), np.uint8)
    t_mat = np.zeros((b, rows + 2 * t_pad), np.uint8)
    for i, (q, t, _, _) in enumerate(pairs):
        q_mat[i, : len(q)] = np.frombuffer(q, np.uint8)
        t_mat[i, t_pad : t_pad + len(t)] = np.frombuffer(t, np.uint8)
    lens = lambda k: np.asarray([len(p[k]) for p in pairs], np.int32)  # noqa: E731
    return (
        q_mat, lens(0), t_mat, lens(1),
        np.asarray([p[2] for p in pairs], np.int32), np.asarray([p[3] for p in pairs], np.int32),
    )


def _time(fn) -> float:
    import jax

    jax.block_until_ready(fn())  # compiled, warm
    times = []
    for _ in range(TIMING_REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_parity(db) -> dict:
    import jax.numpy as jnp
    import numpy as np
    from oracles import banded_swg_oracle

    from kaptive_tpu.core.pairwise import blosum62_matrix
    from kaptive_tpu.ops import swg_cuda
    from kaptive_tpu.ops.mapper import _NT_MATRIX, NT_GAP_EXTEND, NT_GAP_OPEN
    from kaptive_tpu.ops.swg import banded_swg, compress_matrix_cached
    from kaptive_tpu.serotyping import Serotyper

    t0 = time.perf_counter()
    so = swg_cuda.register()
    log(f"parity: CUDA SWG library {so.name} ready in {time.perf_counter() - t0:.1f}s (set-up)")

    serotyper = Serotyper(db)
    rng = np.random.default_rng(SEED)
    plans = [
        ("protein", serotyper._protein_lattice, np.asarray(blosum62_matrix(), np.int32),
         serotyper._protein_aligner.gap_open, serotyper._protein_aligner.gap_extend),
        ("extension", serotyper._ext_lattice, _NT_MATRIX, NT_GAP_OPEN, NT_GAP_EXTEND),
    ]
    times = {}
    widest = None
    for kind, lattice, matrix, go, ge in plans:
        for rows, w, b in lattice.shapes():
            w_lo = max([x for x in lattice.widths if x < w], default=0)
            rows_lo = max([x for x in lattice.tiers if x < rows], default=0)
            if kind == "protein":
                pairs = _protein_pairs(rng, db, rows, w_lo, w, b)
            else:
                pairs = _extension_pairs(rng, db, rows, rows_lo, w_lo, w, b)
            host = _bucket(pairs, rows, w)
            dev = [jnp.asarray(x) for x in host]
            statics = dict(gap_open=go, gap_extend=ge, rows_max=rows, w_pad=w, t_pad=w + 2)
            run = {
                impl: functools.partial(banded_swg, *dev, matrix, impl=impl, **statics)
                for impl in ("cuda", "lax")
            }
            got = {impl: [np.asarray(x) for x in fn()] for impl, fn in run.items()}
            fields = got["cuda"]
            check(np.mean(fields[0] > 0) > 0.9, f"{kind} {rows}x{w}x{b}: most pairs scored 0")
            for name, c, x in zip(("scores", "matches", "mismatches", "gaps", "q_starts",
                                   "q_ends", "t_starts", "t_ends"), fields, got["lax"]):
                check(c.dtype == x.dtype and np.array_equal(c, x),
                      f"{kind} {rows}x{w}x{b}: CUDA {name} differs from lax "
                      f"at {np.flatnonzero(c != x)[:8].tolist()}")
            for i in rng.choice(b, ORACLE_SAMPLE, replace=False):
                q, t, off, k = pairs[i]
                want = banded_swg_oracle(
                    np.frombuffer(q, np.uint8), np.frombuffer(t, np.uint8),
                    matrix.astype(np.int64), k, go, ge, is_seeded=True, diag_offset=off,
                )
                want = [want[f] for f in ("score", "matches", "mismatches", "gaps",
                                          "q_start", "q_end", "t_start", "t_end")]
                check([int(f[i]) for f in fields] == want,
                      f"{kind} {rows}x{w}x{b}: pair {i} differs from the numpy oracle")
            t_cuda, t_lax = _time(run["cuda"]), _time(run["lax"])
            times[f"{kind}:{rows}x{w}x{b}"] = (t_cuda, t_lax)
            live = float(np.mean(host[5] * 2 + 3) / w)
            log(f"parity: {kind:9s} rows {rows:5d} w {w:4d} b {b:4d}: CUDA == lax (8 fields), "
                f"{ORACLE_SAMPLE} == oracle; cuda {t_cuda * 1e3:9.3f} ms  lax {t_lax * 1e3:9.3f} ms  "
                f"(x{t_lax / t_cuda:.1f}; band fill {live:.2f})")
            if widest is None or rows * w * b > widest[0]:
                widest = (rows * w * b, dev, matrix, statics)
    _, dev, matrix, statics = widest
    row_lut, col_lut, small = compress_matrix_cached(matrix)
    compiled = swg_cuda.banded_swg_cuda.lower(
        *dev, jnp.asarray(row_lut), jnp.asarray(col_lut), jnp.asarray(small), **statics
    ).compile()
    log(f"parity: widest bucket {statics}: {compiled.memory_analysis()}")
    return times


# --- phase 3/4 ----------------------------------------------------------------------------------
@contextlib.contextmanager
def swg_impl(impl: str):
    r"""Force every banded-SWG dispatch of the typing path to ``impl``."""
    from kaptive_tpu.ops import swg

    orig = swg.banded_swg
    swg.banded_swg = functools.partial(orig, impl=impl)
    try:
        yield
    finally:
        swg.banded_swg = orig


def run_type(gbk: Path, panel, tag: str, seed_mode: str, precompile: bool = False):
    r"""``kaptive-tpu type`` in-process; returns (wall seconds, TSV lines, counters)."""
    from kaptive_tpu import cli
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    tsv, jsonl = WORK / f"{tag}.tsv", WORK / f"{tag}.jsonl"
    tsv.unlink(missing_ok=True)  # the CLI appends to existing outputs
    jsonl.unlink(missing_ok=True)
    argv = ["kaptive-tpu", "type", str(gbk), *(str(p) for p, _, _ in panel),
            "-o", str(tsv), "-j", str(jsonl), "--seed-mode", seed_mode]
    if precompile:
        argv.append("--precompile")
    reset_metrics()
    saved = sys.argv
    sys.argv = argv
    t0 = time.perf_counter()
    try:
        cli.main()
    finally:
        sys.argv = saved
    elapsed = time.perf_counter() - t0
    lines = tsv.read_bytes().splitlines()
    records = [json.loads(x) for x in jsonl.read_text().splitlines() if x.strip()]
    check(len(lines) == len(panel) + 1 and len(records) == len(panel),
          f"{tag}: {len(lines) - 1} TSV rows and {len(records)} JSONL records "
          f"for {len(panel)} assemblies")
    truth = {p.stem: locus for p, locus, _ in panel}
    calls = {row.split(b"\t")[3].decode(): row.split(b"\t")[4].decode() for row in lines[1:]}
    wrong = {a: (calls.get(a), t) for a, t in truth.items() if calls.get(a) != t}
    check(not wrong, f"{tag}: best-locus calls differ from truth (got, want): {wrong}")
    return elapsed, lines, snapshot()


def check_counters(tag: str, counters: dict, seed_mode: str, dp: str) -> None:
    fallbacks = {k: v for k, v in counters.items() if "fallback" in k or k == "map.host_seed.numpy"}
    check(not fallbacks, f"{tag}: fallback counters {fallbacks}")
    if seed_mode == "host":
        check(counters.get("map.host_seed.native", 0) > 0,
              f"{tag}: no native host seeding counted: {counters}")
    other = "lax" if dp == "cuda" else "cuda"
    check(counters.get(f"swg.dispatch.{dp}", 0) > 0 and not counters.get(f"swg.dispatch.{other}"),
          f"{tag}: expected only {dp} SWG dispatches: {counters}")


DP_PHASES = ("map.extension_dp", "type.protein_dp")  # host wall of the two DP sweeps
WARM_PAIRS = 12  # CUDA/lax pairs of warm passes; the first of a pair alternates


def phase_main(gbk: Path, panel) -> None:
    import io

    from kaptive_tpu.utils.profiling import phase_report, reset_phases

    os.environ["KAPTIVE_PROFILE"] = "1"  # phase timers: the DP sweeps' share of a pass
    n = len(panel)
    cold, rows_a, counters = run_type(gbk, panel, "cuda_cold", "host", precompile=True)
    check_counters("cuda_cold", counters, "host", "cuda")
    log(f"main: kaptive-tpu type, {n} assemblies, host-seeded, CUDA DP: cold run "
        f"{cold:.2f}s (warm-up and compiles included); all {n} calls == truth")
    walls = {"cuda": [], "lax": []}
    dp = {"cuda": [], "lax": []}
    order = [impl for i in range(WARM_PAIRS) for impl in (("cuda", "lax"), ("lax", "cuda"))[i % 2]]
    for impl in order:
        reset_phases()
        with swg_impl(impl):
            elapsed, rows, counters = run_type(gbk, panel, f"{impl}_warm", "host")
        phases = phase_report(io.StringIO())
        check_counters(f"{impl}_warm", counters, "host", impl)
        check(rows[1:] == rows_a[1:], f"{impl}_warm: TSV rows differ from the first run")
        walls[impl].append(elapsed)
        dp[impl].append(sum(phases.get(k, (0, 0.0))[1] for k in DP_PHASES))
    for impl in walls:
        log(f"main: warm passes ({n} assemblies, DB load included), {impl} DP: wall median "
            f"{statistics.median(walls[impl]):.4f}s [" + ", ".join(f"{t:.4f}" for t in walls[impl])
            + f"]; DP sweeps median {statistics.median(dp[impl]) * 1e3:.2f} ms [" +
            ", ".join(f"{t * 1e3:.2f}" for t in dp[impl]) + "]")
    won = sum(c < x for c, x in zip(walls["cuda"], walls["lax"]))
    won_dp = sum(c < x for c, x in zip(dp["cuda"], dp["lax"]))
    log(f"main: CUDA faster in {won} of {WARM_PAIRS} pairs by wall, {won_dp} of {WARM_PAIRS} by "
        f"DP sweeps; median of per-pair wall differences (lax - CUDA) "
        f"{statistics.median(x - c for c, x in zip(walls['cuda'], walls['lax'])):.4f}s")
    log("main: phase totals of the last pass (s): " + json.dumps(
        {k: round(v[1], 4) for k, v in sorted(phases.items(), key=lambda kv: -kv[1][1])}))
    log("main: counters of the last pass: "
        + json.dumps({k: v for k, v in sorted(counters.items()) if not k.startswith("swg.shape")}))
    elapsed, rows_d, counters = run_type(gbk, panel, "device_seeded", "device")
    check_counters("device_seeded", counters, "device", "cuda")
    check(rows_d[1:] == rows_a[1:], "device-seeded TSV rows differ from host-seeded rows")
    log(f"seed modes: device-seeded run {elapsed:.2f}s (its compiles included); {n} TSV rows "
        f"byte-identical to host-seeded rows")


# --- --cards ------------------------------------------------------------------------------------
def phase_cards(gbk: Path, panel, n_cards: int) -> None:
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.db import Database
    from kaptive_tpu.parallel.mesh import make_mesh
    from kaptive_tpu.serotyping import Serotyper
    from kaptive_tpu.serotyping.io import KaptiveRow
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    db = Database.from_genbank(gbk)
    mesh = make_mesh(n_cards, model_parallel=2)
    assemblies = [GenomeAssembly.ensure(p) for p, _, _ in panel]
    reset_metrics()
    t0 = time.perf_counter()
    sharded = Serotyper(db, mesh=mesh).batch(assemblies)
    t_sharded = time.perf_counter() - t0
    counters = snapshot()
    log("cards: counters of the sharded batch: "
        + json.dumps({k: v for k, v in sorted(counters.items()) if not k.startswith("swg.shape")}))
    check_counters("sharded", counters, "device", "cuda")  # the mesh path seeds on the device
    t0 = time.perf_counter()
    single = Serotyper(db).batch(assemblies)
    t_single = time.perf_counter() - t0
    calls = [r.best_locus_name for r in sharded]
    check(calls == [locus for _, locus, _ in panel], f"sharded calls {calls} differ from truth")
    for s, m in zip(single, sharded):
        check(bytes(KaptiveRow.from_result(s)) == bytes(KaptiveRow.from_result(m)),
              f"{s.genome}: sharded row differs from the single-card row")
    log(f"cards: mesh {dict(mesh.shape)} over {n_cards} GPUs: {len(panel)} rows byte-identical "
        f"to single-card; first sharded batch {t_sharded:.2f}s, single-card {t_single:.2f}s "
        f"(compiles included)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded four-GPU path and its comparison")
    args = ap.parse_args(argv)
    if not (REPO / "kaptive_tpu").is_dir() or not (REPO / "tests" / "synthetic.py").is_file():
        fail(f"{REPO} is not a kaptive-tpu checkout")
    sys.path[:0] = [str(REPO), str(REPO / "tests")]

    devices = phase_device(args.cards)
    t_start = time.perf_counter()
    try:
        gbk, panel = write_panel()
        if args.cards > 1:
            phase_cards(gbk, panel, args.cards)
        else:
            from kaptive_tpu.db import Database

            phase_parity(Database.from_genbank(gbk))
            phase_main(gbk, panel)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s")
    for line in card_lines():
        log(line)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                              "count": len(devices)}}))


if __name__ == "__main__":
    main()
