r"""Pairwise protein/nucleotide alignment containers and the batched banded aligner.

Capability parity with ``/root/reference/src/kaptive/core/pairwise.py``:
``PairwiseAlignment`` (:35-73, ``pident`` :63), ``PairwiseAlignments`` SoA
(:76-236), ``PairwiseAligner`` (:239-339: defaults gap_open=11 gap_extend=1
band k=20 :251-253, unseeded band ``max(k, |len1-len2|+1)`` :452, seeded band
``k`` with seed diagonal offset :449-451), and the 256x256 BLOSUM62 matrix
(:343-391; standard public matrix values).

The DP itself runs on device via :func:`kaptive_tpu.ops.swg.banded_swg` — see
that module for the device formulation.  Pairs are bucketed by (query length,
target length, band width) into power-of-two shapes so each bucket compiles
once and stays cached.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cache
from typing import Any

import numpy as np
import numpy.typing as npt

from kaptive_tpu.core.collections import SoAContainer, soa
from kaptive_tpu.core.seq import Sequences


@dataclass(frozen=True, slots=True)
class PairwiseAlignment:
    r"""Summary statistics and coordinates for one pairwise alignment."""

    score: int
    matches: int
    mismatches: int
    gaps: int
    q_start: int
    q_end: int
    t_start: int
    t_end: int

    @property
    def pident(self) -> float:
        total = self.matches + self.mismatches + self.gaps
        return (self.matches / total) * 100.0 if total > 0 else 0.0


@dataclass(frozen=True, slots=True)
class PairwiseAlignments(SoAContainer):
    r"""SoA batch of pairwise alignment results.

    Batch protocol derived by :class:`~kaptive_tpu.core.collections.SoAContainer`;
    integer indexing yields a scalar :class:`PairwiseAlignment` view.
    """

    scores: npt.NDArray[np.int32] = soa(np.int32)
    matches: npt.NDArray[np.int32] = soa(np.int32)
    mismatches: npt.NDArray[np.int32] = soa(np.int32)
    gaps: npt.NDArray[np.int32] = soa(np.int32)
    q_starts: npt.NDArray[np.int32] = soa(np.int32)
    q_ends: npt.NDArray[np.int32] = soa(np.int32)
    t_starts: npt.NDArray[np.int32] = soa(np.int32)
    t_ends: npt.NDArray[np.int32] = soa(np.int32)

    def __getitem__(self, item: Any) -> PairwiseAlignment | PairwiseAlignments:
        if isinstance(item, (int, np.integer)):
            if item < 0:
                item += len(self)
            if item < 0 or item >= len(self):
                raise IndexError("Batch index out of range")
            return PairwiseAlignment(
                *(int(getattr(self, name)[item]) for name, _, _ in self._soa_spec()[0])
            )
        # Explicit base call: slots=True dataclasses recreate the class, which
        # breaks zero-argument super() inside method bodies.
        return SoAContainer.__getitem__(self, item)

    @property
    def pidents(self) -> npt.NDArray[np.float64]:
        total = self.matches + self.mismatches + self.gaps
        return np.divide(self.matches * 100.0, total, out=np.zeros(len(self), dtype=np.float64), where=total > 0)


@cache
def blosum62_matrix(fill_value: int = -128) -> npt.NDArray[np.int8]:
    r"""256x256 byte-indexed BLOSUM62 substitution matrix (standard public values)."""
    # Standard BLOSUM62 over the NCBI alphabet ARNDCQEGHILKMFPSTWYVBJZX* .
    blosum62 = np.array(
        [
            [4, -1, -2, -2, 0, -1, -1, 0, -2, -1, -1, -1, -1, -2, -1, 1, 0, -3, -2, 0, -2, -1, -1, -1, -4],
            [-1, 5, 0, -2, -3, 1, 0, -2, 0, -3, -2, 2, -1, -3, -2, -1, -1, -3, -2, -3, -1, -2, 0, -1, -4],
            [-2, 0, 6, 1, -3, 0, 0, 0, 1, -3, -3, 0, -2, -3, -2, 1, 0, -4, -2, -3, 4, -3, 0, -1, -4],
            [-2, -2, 1, 6, -3, 0, 2, -1, -1, -3, -4, -1, -3, -3, -1, 0, -1, -4, -3, -3, 4, -3, 1, -1, -4],
            [0, -3, -3, -3, 9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1, -3, -1, -3, -1, -4],
            [-1, 1, 0, 0, -3, 5, 2, -2, 0, -3, -2, 1, 0, -3, -1, 0, -1, -2, -1, -2, 0, -2, 4, -1, -4],
            [-1, 0, 0, 2, -4, 2, 5, -2, 0, -3, -3, 1, -2, -3, -1, 0, -1, -3, -2, -2, 1, -3, 4, -1, -4],
            [0, -2, 0, -1, -3, -2, -2, 6, -2, -4, -4, -2, -3, -3, -2, 0, -2, -2, -3, -3, -1, -4, -2, -1, -4],
            [-2, 0, 1, -1, -3, 0, 0, -2, 8, -3, -3, -1, -2, -1, -2, -1, -2, -2, 2, -3, 0, -3, 0, -1, -4],
            [-1, -3, -3, -3, -1, -3, -3, -4, -3, 4, 2, -3, 1, 0, -3, -2, -1, -3, -1, 3, -3, 3, -3, -1, -4],
            [-1, -2, -3, -4, -1, -2, -3, -4, -3, 2, 4, -2, 2, 0, -3, -2, -1, -2, -1, 1, -4, 3, -3, -1, -4],
            [-1, 2, 0, -1, -3, 1, 1, -2, -1, -3, -2, 5, -1, -3, -1, 0, -1, -3, -2, -2, 0, -3, 1, -1, -4],
            [-1, -1, -2, -3, -1, 0, -2, -3, -2, 1, 2, -1, 5, 0, -2, -1, -1, -1, -1, 1, -3, 2, -1, -1, -4],
            [-2, -3, -3, -3, -2, -3, -3, -3, -1, 0, 0, -3, 0, 6, -4, -2, -2, 1, 3, -1, -3, 0, -3, -1, -4],
            [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4, 7, -1, -1, -4, -3, -2, -2, -3, -1, -1, -4],
            [1, -1, 1, 0, -1, 0, 0, 0, -1, -2, -2, 0, -1, -2, -1, 4, 1, -3, -2, -2, 0, -2, 0, -1, -4],
            [0, -1, 0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1, 1, 5, -2, -2, 0, -1, -1, -1, -1, -4],
            [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1, 1, -4, -3, -2, 11, 2, -3, -4, -2, -2, -1, -4],
            [-2, -2, -2, -3, -2, -1, -2, -3, 2, -1, -1, -2, -1, 3, -3, -2, -2, 2, 7, -1, -3, -1, -2, -1, -4],
            [0, -3, -3, -3, -1, -2, -2, -3, -3, 3, 1, -2, 1, -1, -2, -2, 0, -3, -1, 4, -3, 2, -2, -1, -4],
            [-2, -1, 4, 4, -3, 0, 1, -1, 0, -3, -4, 0, -3, -3, -2, 0, -1, -4, -3, -3, 4, -3, 0, -1, -4],
            [-1, -2, -3, -3, -1, -2, -3, -4, -3, 3, 3, -3, 2, 0, -3, -2, -1, -2, -1, 2, -3, 3, -3, -1, -4],
            [-1, 0, 0, 1, -3, 4, 4, -2, 0, -3, -3, 1, -1, -3, -1, 0, -1, -2, -2, -2, 0, -3, 4, -1, -4],
            [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -4],
            [-4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, 1],
        ],
        dtype=np.int8,
    )
    alphabet = list(b"ARNDCQEGHILKMFPSTWYVBJZX*")
    score_matrix = np.full((256, 256), fill_value, dtype=np.int8)
    for a, i in enumerate(alphabet):
        for b, j in enumerate(alphabet):
            score_matrix[i, j] = blosum62[a, b]
    score_matrix.flags.writeable = False
    return score_matrix


def _bucket_size(x: int, minimum: int = 64, factor: int = 2) -> int:
    r"""Smallest ``minimum * factor**k`` >= x, bounding jit recompilations.

    ``factor=4`` trades padded DP cells (cheap on device) for a 2x smaller
    compiled-shape lattice — every distinct shape costs a compile, a
    first-execution load and per-batch dispatch latency.
    """
    size = minimum
    while size < x:
        size *= factor
    return size


@dataclass(frozen=True, slots=True)
class PairwiseAligner:
    r"""Batched banded Smith-Waterman-Gotoh aligner (device-backed).

    Defaults mirror the reference: gap_open=11, gap_extend=1, band k=20
    (``pairwise.py:251-253``).
    """

    gap_open: int = 11
    gap_extend: int = 1
    k: int = 20
    mesh: Any = None  # optional jax.sharding.Mesh: shards the pair axis
    lattice: Any = None  # optional SwgLattice: frozen compiled-shape set

    def __call__(self, queries: Sequences, targets: Sequences, seeds: Any | None = None) -> PairwiseAlignments:
        if len(queries.offsets) != len(targets.offsets):
            raise ValueError("Query and target batches must have the same number of sequences.")
        n = len(queries.offsets)
        if n == 0:
            return PairwiseAlignments.empty()

        if seeds is not None:
            offsets_arr = np.asarray(seeds.offsets, dtype=np.int32)
            k_locals = np.full(n, self.k, dtype=np.int32)
        else:
            offsets_arr = np.zeros(n, dtype=np.int32)
            k_locals = np.maximum(
                self.k, np.abs(queries.lengths.astype(np.int64) - targets.lengths.astype(np.int64)) + 1
            ).astype(np.int32)

        return batched_swg_align(
            queries.seqs, queries.offsets, queries.lengths,
            targets.seqs, targets.offsets, targets.lengths,
            offsets_arr, k_locals,
            matrix=np.asarray(blosum62_matrix(), dtype=np.int32),
            gap_open=self.gap_open, gap_extend=self.gap_extend,
            mesh=self.mesh, lattice=self.lattice,
        )

    def align_seeds(self, queries: Sequences, targets: Sequences, seeds: Any) -> PairwiseAlignments:
        paired_queries, paired_targets = seeds.extract_sequences(queries, targets)
        return self(paired_queries, paired_targets, seeds)


_RESULT_FIELDS = ("scores", "matches", "mismatches", "gaps", "q_starts", "q_ends", "t_starts", "t_ends")


@cache
def _stack_result_jit():
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda parts: jnp.stack(parts))


def _stack_result(parts):
    return _stack_result_jit()(parts)


@cache
def _ragged_gather_jit():
    import jax
    import jax.numpy as jnp

    def gather(q_data, t_data, q_off, q_len, t_off, t_len, *, rows_max, t_cols, t_pad):
        """Build one bucket's padded (query, target) matrices on device from
        the uploaded ragged byte streams (zero-filled outside each length)."""
        j = jnp.arange(rows_max, dtype=jnp.int32)[None, :]
        q = q_data[jnp.clip(q_off[:, None] + j, 0, q_data.shape[0] - 1)]
        q = jnp.where(j < q_len[:, None], q, 0).astype(jnp.uint8)
        jt = jnp.arange(t_cols, dtype=jnp.int32)[None, :]
        t = t_data[jnp.clip(t_off[:, None] + (jt - t_pad), 0, t_data.shape[0] - 1)]
        t = jnp.where((jt >= t_pad) & (jt < t_pad + t_len[:, None]), t, 0).astype(jnp.uint8)
        return q, t

    return jax.jit(gather, static_argnames=("rows_max", "t_cols", "t_pad"))


def _ragged_gather_bucket(*args, **kw):
    return _ragged_gather_jit()(*args, **kw)


def batched_swg_align(
    q_data: np.ndarray, q_offsets: np.ndarray, q_lengths: np.ndarray,
    t_data: np.ndarray, t_offsets: np.ndarray, t_lengths: np.ndarray,
    diag_offsets: np.ndarray, k_locals: np.ndarray,
    matrix: np.ndarray, gap_open: int, gap_extend: int,
    mesh=None, lattice=None,
) -> PairwiseAlignments:
    r"""Bucket ragged pairs into padded device batches and run :func:`banded_swg`.

    Bucket-shape policy (:func:`kaptive_tpu.ops.swg.plan_swg_buckets`): with a
    :class:`~kaptive_tpu.ops.swg.SwgLattice` the compiled-shape set is FROZEN
    (one rows value, a couple of band widths, one chunked batch size — all
    precompiled during warm-up, so steady state never compiles); without one,
    shapes quantise dynamically in power-of-4 steps.  Every distinct shape
    costs a compile *and* a first-execution load, which dwarfs padding waste.

    Dispatch policy: all buckets are launched before any device->host
    collection so their executions and transfers overlap (JAX dispatch is
    async; a per-bucket ``np.asarray`` would serialise every round trip).
    """
    import jax.numpy as jnp

    from kaptive_tpu.ops.swg import banded_swg, pad_ragged_to_matrix, plan_swg_buckets

    n = len(q_offsets)
    w_needed = 2 * k_locals.astype(np.int64) + 3
    joint = np.maximum(np.maximum(q_lengths, t_lengths), 1)

    out = {k: np.zeros(n, dtype=np.int32) for k in _RESULT_FIELDS}
    n_dev = int(mesh.devices.size) if mesh is not None else 1
    if n_dev == 1:
        # Upload the ragged byte streams once; each bucket's padded matrices
        # are gathered on device instead of uploading matrix-sized buffers per
        # bucket.  Pow2-pad the flat streams: the on-device gather jit is keyed
        # on the stream shape, and an exact ragged length would recompile it
        # every batch.
        def pow2_pad(x):
            alloc = 1 << 16
            while alloc < len(x):
                alloc *= 2
            return np.pad(x, (0, alloc - len(x)))

        q_data_d = jnp.asarray(pow2_pad(q_data))
        t_data_d = jnp.asarray(pow2_pad(t_data))
    # min_batch must be a multiple of the device count (sharded buckets split
    # the pair axis evenly): smallest such multiple >= 16.
    min_batch = -(-16 // n_dev) * n_dev
    launched = []
    for sel, rows_max, w_pad, b_pad in plan_swg_buckets(
        joint, w_needed, lattice, min_batch=min_batch
    ):
        t_max = rows_max
        t_pad = w_pad + 2
        b = len(sel)
        if b_pad < min_batch:
            b_pad = min_batch

        def pad(x, fill=0):
            o = np.full(b_pad, fill, dtype=np.int32)
            o[:b] = x[sel]
            return o

        ql = pad(q_lengths)
        tl = pad(t_lengths)
        do = pad(diag_offsets)
        kl = pad(k_locals, 1)

        statics = dict(
            gap_open=gap_open, gap_extend=gap_extend,
            rows_max=rows_max, w_pad=w_pad, t_pad=t_pad,
        )
        if n_dev > 1:
            q_mat = np.zeros((b_pad, rows_max), dtype=np.uint8)
            q_mat[:b] = pad_ragged_to_matrix(q_data, q_offsets[sel], q_lengths[sel], rows_max)
            t_mat = np.zeros((b_pad, t_max + 2 * t_pad), dtype=np.uint8)
            t_mat[:b, t_pad : t_pad + t_max] = pad_ragged_to_matrix(
                t_data, t_offsets[sel], t_lengths[sel], t_max
            )
            from kaptive_tpu.parallel.typing import sharded_banded_swg

            res = sharded_banded_swg(
                mesh, q_mat, ql, t_mat, tl, do, kl,
                np.asarray(matrix, dtype=np.int32), **statics,
            )
        else:
            q_mat, t_mat = _ragged_gather_bucket(
                q_data_d, t_data_d,
                jnp.asarray(pad(q_offsets)), jnp.asarray(ql),
                jnp.asarray(pad(t_offsets)), jnp.asarray(tl),
                rows_max=rows_max, t_cols=t_max + 2 * t_pad, t_pad=t_pad,
            )
            res = banded_swg(
                q_mat, jnp.asarray(ql), t_mat, jnp.asarray(tl),
                jnp.asarray(do), jnp.asarray(kl),
                np.asarray(matrix, dtype=np.int32), **statics,
            )
        # One stacked (8, B) device array per bucket -> ONE device->host
        # transfer instead of eight.
        launched.append((sel, len(sel), _stack_result(tuple(res))))

    # ONE blocking fetch over every bucket: a per-bucket np.asarray would pay
    # a full work-queue wait each.
    if launched:
        import jax

        arrs = jax.device_get([stacked for _, _, stacked in launched])
        for (sel, b, _), arr in zip(launched, arrs):
            for i, field in enumerate(_RESULT_FIELDS):
                out[field][sel] = arr[i, :b]

    return PairwiseAlignments(*(out[f] for f in _RESULT_FIELDS))


def batched_swg_align_cigars(
    q_data: np.ndarray, q_offsets: np.ndarray, q_lengths: np.ndarray,
    t_data: np.ndarray, t_offsets: np.ndarray, t_lengths: np.ndarray,
    diag_offsets: np.ndarray, k_locals: np.ndarray,
    matrix: np.ndarray, gap_open: int, gap_extend: int,
):
    r"""Like :func:`batched_swg_align` but with BAM CIGARs from the traceback.

    Returns ``(PairwiseAlignments, Cigars)``; pairs whose op count overflowed
    the device run buffer get an empty CIGAR (stats stay exact).  Uses the lax
    DP path — CIGAR mode is opt-in output parity, not the typing hot path.
    """
    import jax.numpy as jnp

    from kaptive_tpu.core.alignment import Cigars
    from kaptive_tpu.core.collections import cumulative_offsets
    from kaptive_tpu.ops.swg import MAX_CIGAR_OPS, banded_swg_lax_cigars, pad_ragged_to_matrix

    n = len(q_offsets)
    w_needed = 2 * k_locals.astype(np.int64) + 3
    w_buckets = np.array([_bucket_size(int(w), 128) for w in w_needed])
    joint = np.maximum(np.maximum(q_lengths, t_lengths), 1)
    size_buckets = np.array([_bucket_size(int(s), 128) for s in joint])

    out = {k: np.zeros(n, dtype=np.int32) for k in _RESULT_FIELDS}
    ops_out = np.zeros((n, MAX_CIGAR_OPS), dtype=np.uint32)
    n_ops_out = np.zeros(n, dtype=np.int32)

    keys = size_buckets.astype(np.int64) * 10**5 + w_buckets
    launched = []
    for key in np.unique(keys):
        sel = np.nonzero(keys == key)[0]
        rows_max = t_max = int(size_buckets[sel[0]])
        w_pad = int(w_buckets[sel[0]])
        t_pad = w_pad + 2
        b = len(sel)
        b_pad = 16
        while b_pad < b:
            b_pad *= 4
        q_mat = np.zeros((b_pad, rows_max), dtype=np.uint8)
        q_mat[:b] = pad_ragged_to_matrix(q_data, q_offsets[sel], q_lengths[sel], rows_max)
        t_mat = np.zeros((b_pad, t_max + 2 * t_pad), dtype=np.uint8)
        t_mat[:b, t_pad : t_pad + t_max] = pad_ragged_to_matrix(
            t_data, t_offsets[sel], t_lengths[sel], t_max
        )
        pad = lambda v, fill=0: np.concatenate(  # noqa: E731
            [v.astype(np.int32), np.full(b_pad - b, fill, dtype=np.int32)]
        )
        res, ops, n_ops, overflow = banded_swg_lax_cigars(
            jnp.asarray(q_mat), jnp.asarray(pad(q_lengths[sel])),
            jnp.asarray(t_mat), jnp.asarray(pad(t_lengths[sel])),
            jnp.asarray(pad(diag_offsets[sel])), jnp.asarray(pad(k_locals[sel], 1)),
            jnp.asarray(matrix, dtype=jnp.int32),
            gap_open=gap_open, gap_extend=gap_extend,
            rows_max=rows_max, w_pad=w_pad, t_pad=t_pad,
        )
        launched.append((sel, b, res, ops, n_ops, overflow))

    for sel, b, res, ops, n_ops, overflow in launched:
        for field in _RESULT_FIELDS:
            out[field][sel] = np.asarray(getattr(res, field))[:b]
        ops_np = np.asarray(ops)[:b]
        n_np = np.where(np.asarray(overflow)[:b], 0, np.asarray(n_ops)[:b])
        ops_out[sel] = ops_np
        n_ops_out[sel] = n_np

    lengths = n_ops_out.astype(np.int32)
    offsets = cumulative_offsets(lengths)
    flat = np.concatenate(
        [ops_out[i, : lengths[i]] for i in range(n)]
    ) if n and lengths.sum() else np.empty(0, dtype=np.uint32)
    return (
        PairwiseAlignments(*(out[f] for f in _RESULT_FIELDS)),
        Cigars(flat.astype(np.uint32), offsets, lengths),
    )
