"""CLI end-to-end tests: type -> all outputs; convert round-trip; db subcommands."""

import subprocess
import sys

import numpy as np
import pytest

from synthetic import make_genome_from_locus, make_synthetic_db


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(7)
    gbk, truth = make_synthetic_db(tmp, rng, n_loci=3)
    (tmp / "g1.fasta").write_bytes(make_genome_from_locus(rng, truth, "KL1"))
    (tmp / "g2.fasta").write_bytes(make_genome_from_locus(rng, truth, "KL3", sub_rate=0.01))
    return tmp


def _run(args, cwd, **kw):
    from pathlib import Path

    repo_root = Path(__file__).resolve().parent.parent
    env = {
        "KAPTIVE_DB_DIR": str(cwd / "cache"),
        "PATH": "/usr/bin:/bin",
        "HOME": str(cwd),
        "PYTHONPATH": str(repo_root),
        # CPU keeps subprocess compiles fast and deterministic; the GPU path
        # is covered by chip_smoke.py.
        "JAX_PLATFORMS": "cpu",
    }
    import os

    drop = {"XLA_FLAGS"}
    env.update({k: v for k, v in os.environ.items() if k not in env and k not in drop})
    return subprocess.run(
        [sys.executable, "-m", "kaptive_tpu.cli", *args],
        cwd=cwd, env=env, capture_output=True, timeout=600, **kw,
    )


def test_type_and_convert(workdir):
    r = _run(
        ["type", "TestDB.gbk", "g1.fasta", "g2.fasta", "-o", "out.tsv",
         "-j", "res.jsonl", "--pha4ge", "out.pha4ge", "-l", ".", "-g", ".", "-p", ".",
         "--plots", "."],
        workdir,
    )
    assert r.returncode == 0, r.stderr.decode()
    tsv = (workdir / "out.tsv").read_bytes().splitlines()
    assert len(tsv) == 3
    row1 = tsv[1].split(b"\t")
    assert row1[3] == b"g1" and row1[4] == b"KL1" and row1[6] == b"Typeable"
    row2 = tsv[2].split(b"\t")
    assert row2[4] == b"KL3"
    assert (workdir / "g1_kaptive_results.fna").exists()
    assert (workdir / "g1_kaptive_results.ffn").exists()
    assert (workdir / "g1_kaptive_results.faa").exists()
    assert (workdir / "g1_kaptive_results.html").read_text().startswith("<!DOCTYPE html>")
    assert (workdir / "out.pha4ge").read_bytes().splitlines()[1].split(b"\t")[0] == b"g1"

    # convert reproduces the TSV rows from JSONL without recompute
    r = _run(["convert", "res.jsonl", "-t", "conv.tsv"], workdir)
    assert r.returncode == 0, r.stderr.decode()
    assert (workdir / "conv.tsv").read_bytes().splitlines()[1:] == tsv[1:]


def test_db_subcommands(workdir):
    assert b"KL1" in _run(["db", "extract", "loci", "TestDB.gbk"], workdir).stdout
    assert b">" in _run(["db", "extract", "genes", "TestDB.gbk"], workdir).stdout
    out = _run(["db", "extract", "proteins", "TestDB.gbk", "--use-indices"], workdir).stdout
    assert out.startswith(b">0\n")
    meta = _run(["db", "metadata", "TestDB.gbk"], workdir).stdout.decode()
    assert "Testus syntheticus" in meta and "82.5%" in meta
    avail = _run(["db", "available"], workdir).stdout.decode()
    assert "kpsc_k" in avail
    r = _run(["db", "list"], workdir)
    assert r.returncode == 0


def test_cli_error_handling(workdir):
    r = _run(["type", "nonexistent_db", "g1.fasta", "-o", "out2.tsv"], workdir)
    assert r.returncode != 0
    r = _run(["nonsense-command"], workdir)
    assert r.returncode == 2
    assert b"Error" in r.stderr or b"invalid choice" in r.stderr
    r = _run(["--version"], workdir)
    assert r.returncode == 0


def test_type_screen_only(workdir):
    r = _run(
        ["type", "TestDB.gbk", "g1.fasta", "g2.fasta", "--screen-only",
         "-o", "screen.tsv"],
        workdir,
    )
    assert r.returncode == 0, r.stderr.decode()
    tsv = (workdir / "screen.tsv").read_bytes().splitlines()
    assert tsv[0] == b"Assembly\tBest match locus\tScore"
    assert len(tsv) == 3
    rows = {line.split(b"\t")[0]: line.split(b"\t") for line in tsv[1:]}
    assert rows[b"g1"][1] == b"KL1"
    assert rows[b"g2"][1] == b"KL3"
    assert float(rows[b"g1"][2]) > 0


def test_type_appends_to_existing_outputs(workdir):
    """Existing non-empty TSV/JSONL outputs are appended to, header suppressed
    (reference semantics, docs/serotyping/outputs.md)."""
    out = workdir / "append.tsv"
    jl = workdir / "append.jsonl"
    r1 = _run(["type", "TestDB.gbk", "g1.fasta", "-o", "append.tsv", "-j", "append.jsonl"], workdir)
    assert r1.returncode == 0, r1.stderr.decode()
    r2 = _run(["type", "TestDB.gbk", "g2.fasta", "-o", "append.tsv", "-j", "append.jsonl"], workdir)
    assert r2.returncode == 0, r2.stderr.decode()
    lines = out.read_bytes().splitlines()
    assert len(lines) == 3  # ONE header + one row per run
    assert lines[0].startswith(b"Kaptive version") or b"\t" in lines[0]
    assert sum(1 for ln in lines if ln.startswith(b"Kaptive")) <= 1
    assert lines[1].split(b"\t")[3] == b"g1" and lines[2].split(b"\t")[3] == b"g2"
    assert len(jl.read_bytes().splitlines()) == 2
