"""Validate the row-parallel banded SWG kernel against a sequential oracle."""

import numpy as np
import pytest

from kaptive_tpu.core.pairwise import PairwiseAligner, blosum62_matrix
from kaptive_tpu.core.seq import Sequences
from oracles import banded_swg_oracle

AA = b"ARNDCQEGHILKMFPSTWYV"


def _random_protein(rng, n):
    return bytes(AA[i] for i in rng.integers(0, len(AA), n))


def _mutate(rng, seq, sub_rate=0.1, indel_rate=0.02):
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < indel_rate / 2:
            continue  # deletion
        if r < indel_rate:
            out.append(AA[rng.integers(0, len(AA))])  # insertion
        if rng.random() < sub_rate:
            out.append(AA[rng.integers(0, len(AA))])
        else:
            out.append(c)
    return bytes(out)


def _run_pairs(pairs, seeded=False, offsets=None):
    queries = Sequences.from_bytes([p[0] for p in pairs])
    targets = Sequences.from_bytes([p[1] for p in pairs])
    aligner = PairwiseAligner()
    if seeded:
        class FakeSeeds:
            pass
        s = FakeSeeds()
        s.offsets = np.asarray(offsets, dtype=np.int32)
        res = aligner(queries, targets, seeds=s)
    else:
        res = aligner(queries, targets)
    return res


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_swg_matches_oracle_unseeded(seed):
    rng = np.random.default_rng(seed)
    matrix = blosum62_matrix().astype(np.int64)
    pairs = []
    for _ in range(12):
        n = int(rng.integers(5, 200))
        a = _random_protein(rng, n)
        if rng.random() < 0.7:
            b = _mutate(rng, a, sub_rate=float(rng.random() * 0.3), indel_rate=0.05)
        else:
            b = _random_protein(rng, int(rng.integers(5, 250)))
        pairs.append((a, b))
    # Edge cases: identical, empty query, empty target, single residue
    pairs += [(b"MKV", b"MKV"), (b"", b"MKV"), (b"MKV", b""), (b"A", b"A")]

    res = _run_pairs(pairs)
    for i, (a, b) in enumerate(pairs):
        want = banded_swg_oracle(
            np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8), matrix, 20, 11, 1
        )
        got = {
            "score": int(res.scores[i]), "matches": int(res.matches[i]),
            "mismatches": int(res.mismatches[i]), "gaps": int(res.gaps[i]),
            "q_start": int(res.q_starts[i]), "q_end": int(res.q_ends[i]),
            "t_start": int(res.t_starts[i]), "t_end": int(res.t_ends[i]),
        }
        assert got == want, f"pair {i}: {got} != {want} ({a!r} vs {b!r})"


def test_swg_seeded_offsets():
    rng = np.random.default_rng(7)
    matrix = blosum62_matrix().astype(np.int64)
    a = _random_protein(rng, 80)
    b = _random_protein(rng, 30) + _mutate(rng, a, 0.1, 0.01) + _random_protein(rng, 40)
    pairs = [(a, b)]
    offsets = [-30]  # q_pos - t_pos of the true diagonal
    res = _run_pairs(pairs, seeded=True, offsets=offsets)
    want = banded_swg_oracle(
        np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8), matrix, 20, 11, 1,
        is_seeded=True, diag_offset=-30,
    )
    assert int(res.scores[0]) == want["score"]
    assert int(res.matches[0]) == want["matches"]
    assert int(res.gaps[0]) == want["gaps"]
    assert (int(res.q_starts[0]), int(res.q_ends[0])) == (want["q_start"], want["q_end"])
    assert (int(res.t_starts[0]), int(res.t_ends[0])) == (want["t_start"], want["t_end"])


def test_pident():
    res = _run_pairs([(b"MKVLA", b"MKVLA")])
    assert res.pidents[0] == 100.0
    assert res.matches[0] == 5
