"""Multi-host scaffolding unit tests: input sharding, shard paths, resume."""

import io
import json

import numpy as np
import pytest

from kaptive_tpu.parallel.multihost import (
    ShardedJsonlWriter,
    initialize_distributed,
    shard_inputs,
    shard_path,
)


def test_shard_inputs_partition_and_balance():
    inputs = [f"g{i}.fa" for i in range(10)]
    shards = [shard_inputs(inputs, rank=r, world=3) for r in range(3)]
    # disjoint, covering, balanced within 1
    flat = [x for s in shards for x in s]
    assert sorted(flat) == sorted(inputs)
    assert len(set(flat)) == len(inputs)
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1
    # single process passes through
    assert shard_inputs(inputs, rank=0, world=1) == inputs


def test_shard_path_naming(tmp_path):
    p = tmp_path / "results.jsonl"
    assert shard_path(p, rank=0, world=1) == p
    assert shard_path(p, rank=3, world=8).name == "results.part-00003.jsonl"


def test_initialize_without_coordinator_is_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_distributed() is False


@pytest.mark.parametrize("arg,env,want", [
    ([1], None, [1]),
    (None, "2,3", [2, 3]),
    (None, None, None),
])
def test_initialize_passes_local_device_ids(monkeypatch, arg, env, want):
    import jax

    from kaptive_tpu.parallel import multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: seen.update(kw))
    monkeypatch.setattr(multihost, "_DISTRIBUTED_READY", False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:12345")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    if env is None:
        monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    else:
        monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", env)
    assert initialize_distributed(local_device_ids=arg) is True
    assert seen == dict(
        coordinator_address="localhost:12345", num_processes=4, process_id=2,
        local_device_ids=want,
    )


def test_sharded_writer_resume(tmp_path):
    """Interrupted runs resume: previously written genomes are skipped."""

    class FakeResult:
        def __init__(self, genome):
            self.genome = genome

        def to_dict(self):
            return {"genome": self.genome, "x": 1}

    path = tmp_path / "out.jsonl"
    with ShardedJsonlWriter(path, rank=0, world=1) as w:
        w.write_result(FakeResult("a"))
        w.write_result(FakeResult("b"))
    # simulate a torn tail line from a crash
    with path.open("ab") as fh:
        fh.write(b'{"genome": "c"')

    with ShardedJsonlWriter(path, rank=0, world=1) as w2:
        assert w2.should_skip("a") and w2.should_skip("b")
        assert not w2.should_skip("c")
        w2.write_result(FakeResult("b"))  # duplicate: ignored
        w2.write_result(FakeResult("d"))

    genomes = []
    for line in path.read_bytes().splitlines():
        try:
            genomes.append(json.loads(line)["genome"])
        except ValueError:
            pass
    assert genomes == ["a", "b", "d"]


def test_end_to_end_host_sharded_typing(tmp_path):
    """Simulate a 2-process run on one machine: each 'host' types its input
    shard and writes its own JSONL shard; the union covers every genome once."""
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.db import Database
    from kaptive_tpu.serotyping import Serotyper
    from synthetic import make_genome_from_locus, make_synthetic_db

    rng = np.random.default_rng(5)
    gbk, truth = make_synthetic_db(tmp_path, rng, n_loci=4, genes_per_locus=3)
    db = Database.from_genbank(gbk)
    names = [f"KL{i % 4 + 1}" for i in range(6)]
    fastas = [make_genome_from_locus(rng, truth, n, flank=1200) for n in names]

    ser = Serotyper(db)
    out = tmp_path / "res.jsonl"
    world = 2
    for rank in range(world):
        my = shard_inputs(list(range(6)), rank=rank, world=world)
        with ShardedJsonlWriter(out, rank=rank, world=world) as w:
            for i in my:
                ga = GenomeAssembly.from_stream(io.BytesIO(fastas[i]), f"g{i}")
                if w.should_skip(ga.id):
                    continue
                w.write_result(ser(ga))

    seen = {}
    for rank in range(world):
        for line in shard_path(out, rank=rank, world=world).read_bytes().splitlines():
            d = json.loads(line)
            seen[d["genome"]] = d["best_locus_name"]
    assert sorted(seen) == [f"g{i}" for i in range(6)]
    assert [seen[f"g{i}"] for i in range(6)] == names
