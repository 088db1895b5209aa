"""The lax banded SWG against the numpy oracle at the typing lattices' real widths.

``tests/test_swg.py`` covers the protein aligner at its default band; here
the plain lax path (the CPU path and the reference the CUDA kernel is held to)
runs at the bucket shapes ``Serotyper`` compiles for a KpSC-scale database:
nucleotide extension windows (the mapper's 2-bit codes and scores) of 1,024
rows at the 512-wide band, and BLOSUM62 protein pairs at the 128/384/640
widths.
"""

import numpy as np
import pytest

from kaptive_tpu.core.pairwise import blosum62_matrix
from kaptive_tpu.ops.mapper import _NT_MATRIX, NT_GAP_EXTEND, NT_GAP_OPEN
from kaptive_tpu.ops.minimizer import encode_dna
from kaptive_tpu.ops.swg import banded_swg_lax
from oracles import banded_swg_oracle
from synthetic import mutate_dna, random_dna

AA = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)


def _codes(seq: bytes) -> bytes:
    return encode_dna(np.frombuffer(seq, np.uint8)).tobytes()


def _extension_pair(rng, rows, k):
    gene = random_dna(rng, int(rng.integers(rows // 2, rows * 3 // 4)))
    body = mutate_dna(rng, gene, sub_rate=0.02, indel_rate=0.01)
    span = rows - len(body)
    left = int(rng.integers(0, span + 1))
    t = random_dna(rng, left) + body + random_dna(rng, span - left)
    return _codes(gene), _codes(t), -left, k


def _protein_pair(rng, rows, k):
    n = int(rng.integers(k + 10, rows))
    q = AA[rng.integers(0, len(AA), n)]
    t = q[: n - (k - 1)].copy()  # a truncated hit: k = |len diff| + 1
    hit = rng.random(len(t)) < 0.15
    t[hit] = AA[rng.integers(0, len(AA), int(hit.sum()))]
    return q.tobytes(), t.tobytes(), 0, k


@pytest.mark.parametrize("kind,rows,w_pad,k", [
    ("extension", 1024, 512, 200),
    ("protein", 384, 128, 40),
    ("protein", 384, 384, 150),
    ("protein", 384, 640, 250),
])
def test_lax_matches_oracle_at_lattice_width(kind, rows, w_pad, k):
    rng = np.random.default_rng(rows + w_pad)
    if kind == "extension":
        matrix, go, ge, make = _NT_MATRIX, NT_GAP_OPEN, NT_GAP_EXTEND, _extension_pair
    else:
        matrix, go, ge, make = blosum62_matrix().astype(np.int32), 11, 1, _protein_pair
    pairs = [make(rng, rows, k) for _ in range(2)]
    t_pad = w_pad + 2
    q_mat = np.zeros((len(pairs), rows), np.uint8)
    t_mat = np.zeros((len(pairs), rows + 2 * t_pad), np.uint8)
    for i, (q, t, _, _) in enumerate(pairs):
        q_mat[i, : len(q)] = np.frombuffer(q, np.uint8)
        t_mat[i, t_pad : t_pad + len(t)] = np.frombuffer(t, np.uint8)
    res = banded_swg_lax(
        q_mat, np.asarray([len(p[0]) for p in pairs], np.int32),
        t_mat, np.asarray([len(p[1]) for p in pairs], np.int32),
        np.asarray([p[2] for p in pairs], np.int32), np.asarray([p[3] for p in pairs], np.int32),
        matrix, gap_open=go, gap_extend=ge, rows_max=rows, w_pad=w_pad, t_pad=t_pad,
    )
    for i, (q, t, off, kl) in enumerate(pairs):
        want = banded_swg_oracle(
            np.frombuffer(q, np.uint8), np.frombuffer(t, np.uint8), matrix.astype(np.int64),
            kl, go, ge, is_seeded=True, diag_offset=off,
        )
        got = [int(np.asarray(f)[i]) for f in res]
        assert got == [want[key] for key in (
            "score", "matches", "mismatches", "gaps", "q_start", "q_end", "t_start", "t_end"
        )], f"pair {i}"
        assert want["score"] > 0
