"""Real multi-process execution proof for the multi-host scaffolding.

Round 2 shipped ``parallel/multihost.py`` unit-tested but never executed with
``process_count > 1``.  This test launches TWO actual subprocesses that rendez-
vous through ``jax.distributed.initialize`` on a localhost coordinator (CPU
backend), each types its ``shard_inputs`` slice of a shared genome list and
writes a ``ShardedJsonlWriter`` shard, and the parent asserts the merged
shards are byte-for-byte the records a single-process run produces
(SURVEY.md §2.3 / §7.4-6: per-host IO sharding with rank-0-free merge).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from synthetic import make_genome_from_locus, make_synthetic_db

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import glob, os, sys
rank = int(sys.argv[1]); port = sys.argv[2]; fixdir = sys.argv[3]; outdir = sys.argv[4]
repo = sys.argv[5]
os.environ["JAX_COORDINATOR_ADDRESS"] = "localhost:%s" % port
os.environ["JAX_NUM_PROCESSES"] = "2"
os.environ["JAX_PROCESS_ID"] = str(rank)
sys.path.insert(0, repo)
# jax.distributed.initialize must run before anything touches the XLA
# backend: pin the platform by config (pure config, no backend init), then
# initialise distributed through the library helper, THEN use jax.
import jax
jax.config.update("jax_platforms", "cpu")
from kaptive_tpu.parallel.multihost import (
    ShardedJsonlWriter, initialize_distributed, shard_inputs,
)
assert initialize_distributed(), "coordinator env was set; init must engage"
assert jax.process_count() == 2, jax.process_count()
assert jax.process_index() == rank, (jax.process_index(), rank)
from kaptive_tpu.db import Database
from kaptive_tpu.serotyping import Serotyper

db = Database.from_genbank(os.path.join(fixdir, "TestDB.gbk"))
serotyper = Serotyper(db)
genomes = sorted(glob.glob(os.path.join(fixdir, "genomes", "*.fasta")))
mine = shard_inputs(genomes)
with ShardedJsonlWriter(os.path.join(outdir, "results.jsonl")) as w:
    for result in serotyper.batch(mine):
        w.write_result(result)
print("WORKER_OK", rank, len(mine), flush=True)
"""


def test_two_process_distributed_typing(tmp_path):
    rng = np.random.default_rng(77)
    gbk, truth = make_synthetic_db(tmp_path, rng, n_loci=3, genes_per_locus=4)
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    names = []
    for i, locus in enumerate(["KL1", "KL2", "KL3", "KL1"]):
        fa = make_genome_from_locus(rng, truth, locus, contig_name=f"g{i}", flank=2000)
        (gdir / f"g{i}.fasta").write_bytes(fa)
        names.append(f"g{i}")

    # Single-process reference records (this pytest process, CPU backend).
    from kaptive_tpu.db import Database
    from kaptive_tpu.serotyping import Serotyper
    from kaptive_tpu.serotyping.cli import result_to_jsonl_bytes

    db = Database.from_genbank(gbk)
    serotyper = Serotyper(db)
    genomes = sorted(str(p) for p in gdir.glob("*.fasta"))
    expected = {}
    for result in serotyper.batch(genomes):
        expected[result.genome] = json.loads(result_to_jsonl_bytes(result))

    # Two real processes, rendezvous over a localhost coordinator.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    outdir = tmp_path / "out"
    outdir.mkdir()
    env = {
        k: v for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))  # a clean slate for the workers
    }
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), str(rank), str(port), str(tmp_path), str(outdir), str(REPO)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out}"
        assert f"WORKER_OK {rank} 2" in out, out  # 4 genomes round-robin 2 ways

    # Merge the two shards; records must equal the single-process run's.
    shards = sorted(outdir.glob("results.part-*.jsonl"))
    assert len(shards) == 2, shards
    merged = {}
    for shard in shards:
        for line in shard.read_bytes().splitlines():
            if line.strip():
                rec = json.loads(line)
                merged[rec["genome"]] = rec
    assert set(merged) == set(expected) == set(names)
    for genome in expected:
        assert merged[genome] == expected[genome], f"record mismatch for {genome}"
