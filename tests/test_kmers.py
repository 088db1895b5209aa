"""Sketch index tests: FracMinHash, randstrobes, seed containers."""

import numpy as np
import pytest

from kaptive_tpu.core.kmers import (
    FracMinHashIndex,
    RandstrobeIndex,
    Seeds,
    splitmix64,
)
from kaptive_tpu.core.seq import Sequences
from synthetic import mutate_dna, random_dna, revcomp


def _ref_fracminhash(seq: bytes, k=21, scaled=100):
    """Sequential oracle of the reference's rolling FracMinHash kernel semantics."""
    lut = {65: 0, 67: 1, 84: 2, 71: 3, 97: 0, 99: 1, 116: 2, 103: 3}
    mask = (1 << (2 * k)) - 1
    threshold = (2**64 - 1) // scaled
    kf = kr = 0
    valid = 0
    out = []
    for j, ch in enumerate(seq):
        v = lut.get(ch, 4)
        if v < 4:
            kf = ((kf << 2) & mask) | v
            kr = (kr >> 2) | ((v ^ 2) << (2 * (k - 1)))
            valid += 1
            if valid >= k:
                h = int(splitmix64(np.uint64(min(kf, kr))))
                if h <= threshold:
                    out.append((h, j - k + 1))
        else:
            valid = kf = kr = 0
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_fracminhash_matches_rolling_oracle(seed):
    rng = np.random.default_rng(seed)
    seq = bytearray(random_dna(rng, 5000))
    # sprinkle some Ns to exercise invalid-char resets
    for i in rng.integers(0, len(seq), 10):
        seq[i] = ord("N")
    seq = bytes(seq)
    idx = FracMinHashIndex.build(Sequences.from_bytes([seq]))
    want = _ref_fracminhash(seq)
    got = sorted((int(h), int(p)) for h, p in zip(idx.records["hash"], idx.records["pos1"]))
    assert got == sorted(want)


def test_fracminhash_canonical():
    rng = np.random.default_rng(3)
    seq = random_dna(rng, 4000)
    a = FracMinHashIndex.build(Sequences.from_bytes([seq]), sort_by_hash=True)
    b = FracMinHashIndex.build(Sequences.from_bytes([revcomp(seq)]), sort_by_hash=True)
    np.testing.assert_array_equal(a.records["hash"], b.records["hash"])


def test_randstrobe_build_and_top_hits():
    rng = np.random.default_rng(5)
    prots = []
    aa = b"ARNDCQEGHILKMFPSTWYV"
    for n in (120, 200, 150):
        prots.append(bytes(aa[i] for i in rng.integers(0, len(aa), n)))
    targets = Sequences.from_bytes(prots)
    t_idx = RandstrobeIndex.build(targets, sort_by_hash=True)
    assert len(t_idx) > 0

    # Queries: slightly mutated copies of targets, in shuffled order
    order = [2, 0, 1]
    q_seqs = []
    for i in order:
        p = bytearray(prots[i])
        for j in rng.integers(0, len(p), max(1, len(p) // 20)):
            p[j] = aa[rng.integers(0, len(aa))]
        q_seqs.append(bytes(p))
    queries = Sequences.from_bytes(q_seqs)
    seeds = t_idx.top_hits(queries, min_score=1)
    found = {int(q): int(t) for q, t in zip(seeds.query_indices, seeds.target_indices)}
    for qi, ti in enumerate(order):
        assert found.get(qi) == ti, f"query {qi} should hit target {ti}, got {found}"


def test_randstrobe_requires_sorted_target():
    rng = np.random.default_rng(1)
    seqs = Sequences.from_bytes([bytes(b"ARNDCQEGHILKMFPSTWYV" * 10)])
    unsorted = RandstrobeIndex.build(seqs, sort_by_hash=False)
    with pytest.raises(ValueError):
        unsorted.top_hits(seqs)


def test_seeds_container():
    s = Seeds(
        np.array([0, 1, 1], dtype=np.uint32),
        np.array([2, 3, 4], dtype=np.uint32),
        np.array([10, 5, 9], dtype=np.uint32),
        np.array([-3, 0, 7], dtype=np.int32),
    )
    assert len(s) == 3
    assert s[0].score == 10
    top = s.top_hits()
    assert len(top) == 2
    assert list(top.scores) == [10, 9]
    assert list(top.target_indices) == [2, 4]
    assert len(Seeds.empty()) == 0
    assert len(Seeds.concat([s, s])) == 6
