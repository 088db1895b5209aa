"""The CUDA banded-SWG kernel must match the lax path bit-for-bit.

The lax path is itself validated against the sequential oracle in
``tests/test_swg.py`` and ``tests/test_swg_lattice.py``; here the Hopper
kernel (:mod:`kaptive_tpu.ops.swg_cuda`) must produce identical scores,
counts and coordinates.  The kernel has no interpret mode, so these cases
carry the ``gpu`` marker and skip without a GPU; the matrix factorisation it
relies on is checked everywhere.
"""

import numpy as np
import pytest

from kaptive_tpu.core.pairwise import blosum62_matrix
from kaptive_tpu.ops.swg import banded_swg, compress_matrix, pad_ragged_to_matrix
from oracles import banded_swg_oracle

AA = b"ARNDCQEGHILKMFPSTWYV"
NT = b"ACGT"


def _nt_matrix():
    m = np.full((256, 256), -4, dtype=np.int32)
    for b in NT:
        m[b, b] = 2
    return m


def test_compress_matrix_exact():
    for matrix in (blosum62_matrix().astype(np.int32), _nt_matrix()):
        out = compress_matrix(matrix)
        assert out is not None
        row_lut, col_lut, small = out
        a = np.arange(256)
        assert np.array_equal(matrix, small[np.ix_(row_lut[a], col_lut[a])])


def _random_batch(rng, alphabet, n_pairs, max_len, seeded, k):
    qs, ts, offs, kls = [], [], [], []
    for _ in range(n_pairs):
        n = int(rng.integers(3, max_len))
        q = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))
        if rng.random() < 0.6:
            t = bytearray(q)
            for _ in range(int(rng.integers(0, max(1, n // 4)))):
                t[int(rng.integers(0, len(t)))] = alphabet[rng.integers(0, len(alphabet))]
            t = bytes(t)
        else:
            t = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), int(rng.integers(3, max_len))))
        qs.append(q)
        ts.append(t)
        offs.append(int(rng.integers(-8, 8)) if seeded else 0)
        kls.append(k if seeded else max(k, abs(len(q) - len(t)) // 2 + 1))
    return qs, ts, np.asarray(offs, np.int32), np.asarray(kls, np.int32)


def _pack(seqs, width):
    data = np.frombuffer(b"".join(seqs), np.uint8)
    lens = np.asarray([len(s) for s in seqs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return pad_ragged_to_matrix(data, offsets, lens, width), lens.astype(np.int32)


def _bucket(qs, ts, rows_max, w_pad):
    t_pad = w_pad + 2
    q_mat, q_lens = _pack(qs, rows_max)
    t_inner, t_lens = _pack(ts, rows_max)
    t_mat = np.zeros((len(ts), rows_max + 2 * t_pad), dtype=np.uint8)
    t_mat[:, t_pad : t_pad + rows_max] = t_inner
    return q_mat, q_lens, t_mat, t_lens


@pytest.mark.gpu
@pytest.mark.parametrize("alphabet,matrix_fn,seeded,rows_max,w_pad", [
    (AA, lambda: blosum62_matrix().astype(np.int32), False, 128, 128),
    (AA, lambda: blosum62_matrix().astype(np.int32), True, 128, 128),
    (NT, _nt_matrix, False, 128, 128),
    (NT, _nt_matrix, True, 1600, 512),
    (AA, lambda: blosum62_matrix().astype(np.int32), False, 384, 640),
])
def test_cuda_matches_lax(gpu, alphabet, matrix_fn, seeded, rows_max, w_pad):
    rng = np.random.default_rng(rows_max + w_pad + seeded)
    matrix = matrix_fn()
    k = (w_pad - 3) // 2 if w_pad > 128 else 20
    qs, ts, offs, kls = _random_batch(
        rng, alphabet, n_pairs=48, max_len=rows_max - 4, seeded=seeded, k=min(k, 60)
    )
    kls = np.minimum(kls, (w_pad - 3) // 2)
    q_mat, q_lens, t_mat, t_lens = _bucket(qs, ts, rows_max, w_pad)

    kwargs = dict(gap_open=11, gap_extend=1, rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    lax_res = banded_swg(q_mat, q_lens, t_mat, t_lens, offs, kls, matrix, impl="lax", **kwargs)
    cuda_res = banded_swg(q_mat, q_lens, t_mat, t_lens, offs, kls, matrix, impl="cuda", **kwargs)
    for f in lax_res._fields:
        got = np.asarray(getattr(cuda_res, f))
        want = np.asarray(getattr(lax_res, f))
        assert got.dtype == want.dtype, f
        assert np.array_equal(got, want), f"{f}: {got} != {want}"

    for i in range(0, len(qs), 12):  # the numpy oracle on a sample
        want = banded_swg_oracle(
            np.frombuffer(qs[i], np.uint8), np.frombuffer(ts[i], np.uint8),
            matrix.astype(np.int64), int(kls[i]), 11, 1,
            is_seeded=True, diag_offset=int(offs[i]),
        )
        got = [int(np.asarray(getattr(cuda_res, f))[i]) for f in cuda_res._fields]
        assert got == [want[key] for key in (
            "score", "matches", "mismatches", "gaps", "q_start", "q_end", "t_start", "t_end"
        )]


@pytest.mark.parametrize("impl,platform,w_pad,want", [
    ("auto", "cpu", 512, "lax"),
    ("auto", "gpu", 512, "cuda"),
    ("auto", "gpu", 4096, "lax"),  # wider than the kernel's widest band
    ("lax", "gpu", 512, "lax"),
    ("cuda", "gpu", 128, "cuda"),
    ("cuda", "cpu", 512, RuntimeError),  # forced off the card: never falls back
    ("cuda", "gpu", 4096, ValueError),
])
def test_choose_impl(impl, platform, w_pad, want):
    from kaptive_tpu.ops.swg import choose_impl, compress_matrix

    rows = 1600
    compressed = compress_matrix(_nt_matrix())
    args = (impl, platform, rows, w_pad, rows + 2 * (w_pad + 2), compressed)
    if isinstance(want, type):
        with pytest.raises(want):
            choose_impl(*args)
    else:
        assert choose_impl(*args) == want


def test_forced_cuda_off_the_card_raises():
    q_mat, q_lens, t_mat, t_lens = _bucket([b"ACGT"], [b"ACGT"], 128, 128)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        banded_swg(
            q_mat, q_lens, t_mat, t_lens, np.zeros(1, np.int32), np.full(1, 20, np.int32),
            _nt_matrix(), gap_open=11, gap_extend=1, rows_max=128, w_pad=128, t_pad=130,
            impl="cuda",
        )


def test_sharded_dispatch_follows_the_mesh_platform(monkeypatch):
    r"""A CPU mesh takes the lax path even when the default device is a GPU."""
    import jax

    from kaptive_tpu import platform
    from kaptive_tpu.parallel.mesh import make_mesh
    from kaptive_tpu.parallel.typing import sharded_banded_swg
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    rng = np.random.default_rng(7)
    qs, ts, offs, kls = _random_batch(rng, NT, n_pairs=8, max_len=100, seeded=True, k=20)
    q_mat, q_lens, t_mat, t_lens = _bucket(qs, ts, 128, 128)
    kwargs = dict(gap_open=11, gap_extend=1, rows_max=128, w_pad=128, t_pad=130)
    want = banded_swg(q_mat, q_lens, t_mat, t_lens, offs, kls, _nt_matrix(), impl="lax", **kwargs)

    monkeypatch.setattr(platform, "default_platform", lambda: "gpu")
    mesh = make_mesh(4, model_parallel=2, devices=jax.devices("cpu"))
    reset_metrics()
    got = sharded_banded_swg(mesh, q_mat, q_lens, t_mat, t_lens, offs, kls, _nt_matrix(), **kwargs)
    counters = snapshot()
    assert counters.get("swg.dispatch.lax", 0) > 0 and "swg.dispatch.cuda" not in counters
    for f in want._fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
