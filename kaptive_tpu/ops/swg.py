r"""Batched banded Smith-Waterman-Gotoh DP (JAX row-parallel formulation).

This is the device equivalent of the reference's per-cell Numba kernel
``_batched_banded_gotoh`` (``/root/reference/src/kaptive/core/pairwise.py:395-584``)
and the score-producing core of the rammappy extension stage it wraps.  The
recurrence, band geometry (``2k+3`` wide band with zero-scoring border cells),
local-alignment reset, maximum tracking (first cell wins ties) and traceback
tie-breaking (diagonal > D > I; gap-open when ``open >= extend``) are preserved
exactly so that scores, match/mismatch/gap counts and coordinates are
bit-identical to the reference.

Design — why this is not a transliteration:

The reference fills one cell at a time; within a row, the horizontal gap state
``I[j]`` depends on ``M[j-1]`` of the same row, which defeats naive
vectorisation.  Here each row is computed as whole-band vector operations:

1. ``D`` (vertical gaps) from the previous row's band (one shifted vector max).
2. ``H = max(diag + score, D)`` clamped at 0 (local reset) — no ``I`` yet.
3. ``I`` via a *max-plus prefix scan*: unrolling Gotoh's horizontal recurrence
   gives ``I[j] = max_{j'<j}(M[j'] - open - (j-j')*extend)``; chains through
   ``I`` itself never beat direct extension (one gap-open vs two), so the scan
   input can be the clamped ``H`` — this is the classic Farrar/Rognes lazy-F
   argument, realised exactly with one ``cummax``.
4. ``M = max(H, I)``; traceback bits re-derived vectorially with the
   reference's exact comparison order and packed 4-bits-per-cell.

Rows are iterated with ``lax.scan``, pairs are ``vmap``-batched, and the band
is laid out in diagonal coordinates so the per-row shifts are static slices.
Traceback is a short ``lax.while_loop`` per pair over the packed bit matrix.

This lax path is the plain reference and the CPU path.  On a GPU,
:func:`banded_swg` routes each bucket to the CUDA kernel
(:mod:`kaptive_tpu.ops.swg_cuda`), which computes the same recurrence with the
band in registers and the row loop and traceback inside one launch, and
returns identical results.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = jnp.int32(-1_000_000_000)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True, slots=True)
class SwgLattice:
    r"""A frozen set of compiled DP bucket shapes.

    Dynamic power-of-factor bucketing grows a fresh ``(rows, w, b)`` compiled
    shape whenever a new pair geometry appears, and compiles then dominate
    steady-state runtime.  A lattice fixes
    the shape set up front from what the database can ever produce: ONE row
    count (covering the longest reference sequence plus slack), a small tuple
    of band widths, and ONE batch size (larger pair sets dispatch in chunks).
    All shapes are compiled once during warm-up; pairs that fall outside the
    lattice (adversarial geometry) fall back to dynamic bucketing and are
    counted under ``swg.offlattice``.
    """

    rows: int  # largest rows_max tier (% 64 == 0)
    widths: tuple[int, ...]  # ascending band widths (% 128 == 0 for the CUDA kernel)
    batch: int = 128  # pairs per dispatch (% 8 == 0)
    # Optional refinements (all precompiled by warmup via :meth:`shapes`):
    # ascending row tiers ending in ``rows`` — pairs pick the smallest
    # adequate tier so typical pairs do not pay the worst-case lattice area;
    # ``tail_batch`` adds one smaller dispatch size for the final remainder
    # chunk of a launch group (0 = remainders pad to the full batch).
    row_tiers: tuple[int, ...] = ()
    tail_batch: int = 0

    @classmethod
    def for_max_len(cls, max_len: int, *, len_slack: int = 0, widths: tuple[int, ...] | None = None, batch: int = 128, row_tiers: tuple[int, ...] = (), tail_batch: int = 0) -> "SwgLattice":
        r"""Build a lattice covering pairs up to ``max_len + len_slack``.

        The default width set is (128, W/2, W) where W covers the worst
        unseeded band ``2*(max_len+1)+3`` (one truncated side vs a
        full-length other) and the middle tier spares moderately
        length-mismatched pairs the worst-case band.
        """
        rows = _round_up(max(int(max_len) + int(len_slack), 64), 64)
        if widths is None:
            wide = _round_up(2 * int(max_len) + 5, 128)
            mid = _round_up(wide // 2, 128)
            widths = (128,) + tuple(
                w for w in (mid, wide) if w > 128
            )
        return cls(rows, tuple(int(w) for w in widths), int(batch),
                   tuple(int(r) for r in row_tiers), int(tail_batch))

    @property
    def tiers(self) -> tuple[int, ...]:
        return self.row_tiers if self.row_tiers else (self.rows,)

    def batches_for(self, width: int) -> tuple[int, ...]:
        r"""Dispatch sizes for a width: the tail shape exists only above the
        narrowest band — padding there is cheap, and every compiled shape
        costs warmup time."""
        if self.tail_batch and width > self.widths[0]:
            return (self.batch, self.tail_batch)
        return (self.batch,)

    def shapes(self) -> list[tuple[int, int, int]]:
        return [
            (r, w, b)
            for r in self.tiers
            for w in self.widths
            for b in self.batches_for(w)
        ]

    def width_for(self, w_needed: int) -> int | None:
        for w in self.widths:
            if w >= w_needed:
                return w
        return None


def plan_swg_buckets(
    joint: np.ndarray, w_needed: np.ndarray, lattice: SwgLattice | None,
    *, dyn_min_size: int = 256, dyn_min_w: int = 128, dyn_factor: int = 4,
    min_batch: int = 16,
) -> list[tuple[np.ndarray, int, int, int]]:
    r"""Assign pairs to compiled bucket shapes.

    Returns a list of ``(pair_indices, rows_max, w_pad, b_pad)`` launch groups.
    With a lattice, in-range pairs share its frozen shapes (chunked at
    ``lattice.batch``); out-of-range pairs (and all pairs when no lattice is
    given) use the dynamic power-of-``dyn_factor`` bucketing with ×4 batch
    quantisation.
    """
    from kaptive_tpu.utils.metrics import count

    def dyn_bucket(x: int, minimum: int) -> int:
        size = minimum
        while size < x:
            size *= dyn_factor
        return size

    n = len(joint)
    rows_of = np.empty(n, dtype=np.int64)
    w_of = np.empty(n, dtype=np.int64)
    on_lattice = np.zeros(n, dtype=bool)
    if lattice is not None:
        widths = np.asarray(lattice.widths, dtype=np.int64)
        tiers = np.asarray(lattice.tiers, dtype=np.int64)
        wi = np.searchsorted(widths, np.asarray(w_needed, dtype=np.int64))
        ri = np.searchsorted(tiers, np.asarray(joint, dtype=np.int64))
        on_lattice = (ri < len(tiers)) & (wi < len(widths))
        rows_of[on_lattice] = tiers[ri[on_lattice]]
        w_of[on_lattice] = widths[wi[on_lattice]]
    off = ~on_lattice
    if off.any():
        if lattice is not None:
            count("swg.offlattice", int(off.sum()))
        rows_of[off] = [dyn_bucket(int(s), dyn_min_size) for s in joint[off]]
        w_of[off] = [dyn_bucket(int(w), dyn_min_w) for w in w_needed[off]]

    groups: list[tuple[np.ndarray, int, int, int]] = []
    keys = rows_of * 10**6 + w_of
    for key in np.unique(keys):
        sel = np.nonzero(keys == key)[0]
        rows_max = int(rows_of[sel[0]])
        w_pad = int(w_of[sel[0]])
        if lattice is not None and bool(on_lattice[sel[0]]):
            # Round the frozen batch up to a multiple of min_batch so a
            # multi-device mesh whose device count does not divide the
            # lattice batch (non-power-of-two meshes) still gets an evenly
            # shardable pair axis.
            b_fix = -(-lattice.batch // min_batch) * min_batch
            t_fix = -(-lattice.tail_batch // min_batch) * min_batch if lattice.tail_batch else 0
            for start in range(0, len(sel), b_fix):
                part = sel[start : start + b_fix]
                # The final remainder rides the smaller precompiled tail
                # shape when it fits — padding 60 live pairs to 384 at the
                # widest band was ~6x wasted lattice area.  (Tail shapes
                # exist only above the narrowest width; see batches_for.)
                b_here = (
                    t_fix
                    if (t_fix and len(part) <= t_fix and w_pad > lattice.widths[0])
                    else b_fix
                )
                groups.append((part, rows_max, w_pad, b_here))
        else:
            b = len(sel)
            b_pad = min_batch
            while b_pad < b:
                b_pad *= 4
            groups.append((sel, rows_max, w_pad, b_pad))
    return groups


class SwgResult(NamedTuple):
    r"""Flat per-pair alignment statistics (mirrors ``PairwiseAlignments`` fields)."""

    scores: jax.Array
    matches: jax.Array
    mismatches: jax.Array
    gaps: jax.Array
    q_starts: jax.Array
    q_ends: jax.Array
    t_starts: jax.Array
    t_ends: jax.Array


def _fill_band(
    q: jax.Array,  # (Lq,) int32 byte/alphabet codes
    t_padded: jax.Array,  # (Lt + 2*PAD,) int32, padded both sides
    len1: jax.Array,  # scalar int32
    len2: jax.Array,  # scalar int32
    offset: jax.Array,  # scalar int32 diagonal offset (q_pos - t_pos of seed)
    k_local: jax.Array,  # scalar int32 per-pair half band width
    matrix: jax.Array,  # (256, 256) int32 substitution scores
    gap_open: int,
    gap_extend: int,
    rows_max: int,
    w_pad: int,
):
    r"""Scan the DP band over rows; returns packed traceback bits and the max cell."""
    k_pad = (w_pad - 3) // 2
    pad = w_pad + 2
    dm = jnp.arange(w_pad, dtype=jnp.int32)
    goe = jnp.int32(gap_open + gap_extend)
    ge = jnp.int32(gap_extend)
    cols = len2 + 1

    # Row 0 init: padded-band cells get M=0, everything else -INF (ref :465-479).
    j0 = 0 - offset + dm - k_pad - 1  # j per dm slot at row 0
    in_pad0 = (jnp.abs(dm - (k_pad + 1)) <= k_local + 1) & (j0 >= 0) & (j0 < cols)
    m0 = jnp.where(in_pad0, 0, NEG_INF)
    d0 = jnp.full((w_pad,), NEG_INF, dtype=jnp.int32)

    def row_step(carry, i):
        m_prev, d_prev, best, best_i, best_j = carry
        active = i <= len1
        j = i - offset + dm - k_pad - 1  # target 1-based DP column per dm slot
        j_center = i - offset
        filled = (
            active
            & (jnp.abs(dm - (k_pad + 1)) <= k_local)
            & (j >= 1)
            & (j < cols)
        )
        in_pad = active & (jnp.abs(dm - (k_pad + 1)) <= k_local + 1) & (j >= 0) & (j < cols)

        # Vertical gap state D from previous row's dm+1 slots.
        m_up = jnp.concatenate([m_prev[1:], NEG_INF[None]])
        d_up = jnp.concatenate([d_prev[1:], NEG_INF[None]])
        d_open = m_up - goe
        d_ext = d_up - ge
        d_cur = jnp.maximum(d_open, d_ext)
        tb_d_ext = d_open < d_ext  # ref :498-506: open wins ties

        # Diagonal: previous row, same dm slot.
        q_char = q[jnp.clip(i - 1, 0, rows_max - 1)]
        t_start = i - offset - k_pad - 2 + pad  # consecutive j-1 values
        t_slice = jax.lax.dynamic_slice(t_padded, (t_start,), (w_pad,))
        s = matrix[q_char, t_slice]
        diag = m_prev + s

        h_ng = jnp.maximum(diag, d_cur)
        h_ng = jnp.where(filled, h_ng, NEG_INF)
        # Scan input: filled cells clamp at 0; border cells contribute M=0 (ref init).
        h_c = jnp.where(filled, jnp.maximum(h_ng, 0), jnp.where(in_pad, 0, NEG_INF))

        # Horizontal gap state I via exclusive max-plus prefix scan along the band:
        # a gap of length L costs open + L*extend, so I[dm] =
        # max_{dm'<dm}(H[dm'] + dm'*ge) - gap_open - dm*ge.
        keyed = h_c + dm * ge
        run = jax.lax.cummax(keyed)
        run_excl = jnp.concatenate([NEG_INF[None], run[:-1]])
        i_cur = run_excl - jnp.int32(gap_open) - dm * ge
        i_cur = jnp.where(filled, i_cur, NEG_INF)

        m_cur = jnp.where(filled, jnp.maximum(jnp.maximum(h_c, i_cur), 0), jnp.where(in_pad, 0, NEG_INF))

        # Traceback bits with the reference's exact comparison order (:519-531).
        best_v = diag
        tb_m = jnp.zeros((w_pad,), dtype=jnp.int32)
        tb_m = jnp.where(d_cur > best_v, 1, tb_m)
        best_v = jnp.maximum(best_v, d_cur)
        tb_m = jnp.where(i_cur > best_v, 2, tb_m)
        best_v = jnp.maximum(best_v, i_cur)
        tb_m = jnp.where(best_v <= 0, 3, tb_m)
        tb_m = jnp.where(filled, tb_m, 3)

        # tb_I from final M of this row (left neighbour), matching ref :509-514.
        m_left = jnp.concatenate([NEG_INF[None], m_cur[:-1]])
        # Left neighbour may be the in-band border cell: M=0 there.
        i_open = m_left - goe
        i_ext = jnp.concatenate([NEG_INF[None], i_cur[:-1]]) - ge
        tb_i_ext = i_open < i_ext

        tb_packed = (
            tb_m.astype(jnp.uint8)
            | (tb_d_ext.astype(jnp.uint8) << 2)
            | (tb_i_ext.astype(jnp.uint8) << 3)
        )

        # Max tracking: strictly-greater update, first cell in scan order wins (ref :532-535).
        row_best = jnp.max(jnp.where(filled, m_cur, NEG_INF))
        row_arg = jnp.argmax(jnp.where(filled, m_cur, NEG_INF))
        row_j = j[row_arg]
        upd = row_best > best
        best = jnp.where(upd, row_best, best)
        best_i = jnp.where(upd, i, best_i)
        best_j = jnp.where(upd, row_j, best_j)

        return (m_cur, d_cur, best, best_i, best_j), tb_packed

    (m_last, d_last, best, best_i, best_j), tb = jax.lax.scan(
        row_step,
        (m0, d0, jnp.int32(0), jnp.int32(0), jnp.int32(0)),
        jnp.arange(1, rows_max + 1, dtype=jnp.int32),
    )
    return tb, best, best_i, best_j


def _traceback(
    tb: jax.Array,  # (rows_max, w_pad) uint8
    q: jax.Array,
    t_padded: jax.Array,
    best: jax.Array,
    best_i: jax.Array,
    best_j: jax.Array,
    offset: jax.Array,
    w_pad: int,
    rows_max: int,
    t_pad_amount: int,
):
    r"""Replay the reference's traceback state machine (:544-572) over packed bits."""
    k_pad = (w_pad - 3) // 2

    def cond(st):
        i, j, state, matches, mism, gaps, done = st
        return (~done) & (i > 0) & (j > 0)

    def body(st):
        i, j, state, matches, mism, gaps, done = st
        dmv = j - (i - offset) + k_pad + 1
        cell = tb[jnp.clip(i - 1, 0, rows_max - 1), jnp.clip(dmv, 0, w_pad - 1)].astype(jnp.int32)
        tb_m = cell & 3
        tb_d_ext = (cell >> 2) & 1
        tb_i_ext = (cell >> 3) & 1

        qc = q[jnp.clip(i - 1, 0, rows_max - 1)]
        tc = t_padded[jnp.clip(j - 1 + t_pad_amount, 0, t_padded.shape[0] - 1)]
        is_match = qc == tc

        # state 0: in M
        m_stop = (state == 0) & (tb_m == 3)
        m_diag = (state == 0) & (tb_m == 0)
        m_to_d = (state == 0) & (tb_m == 1)
        m_to_i = (state == 0) & (tb_m == 2)
        # state 1: in D (vertical, i-1); state 2: in I (horizontal, j-1)
        in_d = state == 1
        in_i = state == 2

        matches = matches + jnp.where(m_diag & is_match, 1, 0)
        mism = mism + jnp.where(m_diag & ~is_match, 1, 0)
        gaps = gaps + jnp.where(in_d | in_i, 1, 0)

        new_i = i - jnp.where(m_diag | in_d, 1, 0)
        new_j = j - jnp.where(m_diag | in_i, 1, 0)
        new_state = jnp.where(
            m_to_d, 1,
            jnp.where(
                m_to_i, 2,
                jnp.where(in_d & (tb_d_ext == 0), 0, jnp.where(in_i & (tb_i_ext == 0), 0, state)),
            ),
        )
        new_state = jnp.where(m_diag | m_stop, 0, new_state)
        done = done | m_stop
        return (new_i, new_j, new_state, matches, mism, gaps, done)

    i, j, _, matches, mism, gaps, _ = jax.lax.while_loop(
        cond,
        body,
        (best_i, best_j, jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.bool_(False)),
    )
    return matches, mism, gaps, i, j


@functools.partial(
    jax.jit, static_argnames=("gap_open", "gap_extend", "rows_max", "w_pad", "t_pad")
)
def banded_swg_lax(
    q_codes: jax.Array,  # (B, rows_max) int32
    q_lens: jax.Array,  # (B,) int32
    t_codes: jax.Array,  # (B, Lt) int32
    t_lens: jax.Array,  # (B,) int32
    offsets: jax.Array,  # (B,) int32 diagonal offsets
    k_locals: jax.Array,  # (B,) int32 per-pair half band width (2*k+3 <= w_pad)
    matrix: jax.Array,  # (256, 256) int32
    *,
    gap_open: int,
    gap_extend: int,
    rows_max: int,
    w_pad: int,
    t_pad: int,
) -> SwgResult:
    r"""Batched banded local SWG alignment; returns per-pair stats and coordinates.

    ``w_pad`` must satisfy ``w_pad >= 2*max(k_locals)+3``; callers bucket pairs
    so that padding stays tight.  ``t_codes`` must be pre-padded on both sides
    by EXACTLY ``t_pad == w_pad + 2`` sentinel elements (value 0 is fine — the
    band masks exclude out-of-range columns): the band fill derives its target
    window base from the band geometry, so a larger pad would misalign the
    fill against the traceback.
    """
    assert t_pad == w_pad + 2, "banded SWG requires t_pad == w_pad + 2"

    # Inputs arrive uint8 (cheap transfer); compute in int32 on device.
    q_codes = q_codes.astype(jnp.int32)
    t_codes = t_codes.astype(jnp.int32)

    def one(q, t_padded, l1, l2, off, kl):
        tb, best, bi, bj = _fill_band(
            q, t_padded, l1, l2, off, kl, matrix, gap_open, gap_extend, rows_max, w_pad
        )
        matches, mism, gaps, si, sj = _traceback(
            tb, q, t_padded, best, bi, bj, off, w_pad, rows_max, t_pad
        )
        return SwgResult(best, matches, mism, gaps, si, bi, sj, bj)

    return jax.vmap(one)(q_codes, t_codes, q_lens, t_lens, offsets, k_locals)


MAX_ROW_CLASSES = 64  # substitution-matrix row classes the CUDA kernel holds
MAX_COL_CLASSES = 32  # column classes (one shared-memory bank each)


def compress_matrix(matrix: np.ndarray):
    r"""Factor a (256, 256) byte matrix into (row LUT, col LUT, class matrix).

    Exact: ``matrix[a, b] == small[row_lut[a], col_lut[b]]`` for all bytes.
    Returns None when the matrix has more distinct row/column classes than the
    CUDA kernel's shared-memory table holds (such buckets take the lax path).
    """
    if matrix.shape != (256, 256):
        return None
    rows_u, row_inv = np.unique(matrix, axis=0, return_inverse=True)
    cols_u, col_inv = np.unique(rows_u.T, axis=0, return_inverse=True)
    n_row, n_col = rows_u.shape[0], cols_u.shape[0]
    if n_row > MAX_ROW_CLASSES or n_col > MAX_COL_CLASSES:
        return None
    # First byte of each column class (reversed assignment -> first wins).
    first_b = np.zeros(n_col, dtype=np.int64)
    for b in reversed(range(256)):
        first_b[col_inv[b]] = b
    small = rows_u[:, first_b].astype(np.int32)  # (n_row, n_col)
    return row_inv.astype(np.int32).ravel(), col_inv.astype(np.int32).ravel(), small


_COMPRESS_CACHE: dict = {}


def compress_matrix_cached(matrix: np.ndarray):
    # Key on the exact bytes (plus shape/dtype), never a hash of them: a hash
    # collision between two substitution matrices would silently corrupt every
    # alignment score.  The few-hundred-KB keys exist once per distinct matrix.
    arr = np.asarray(matrix, dtype=np.int32)
    key = (arr.shape, arr.tobytes())
    if key not in _COMPRESS_CACHE:
        _COMPRESS_CACHE[key] = compress_matrix(arr)
    return _COMPRESS_CACHE[key]


def choose_impl(
    impl: str, platform: str, rows_max: int, w_pad: int, t_cols: int, compressed
) -> str:
    r"""``"cuda"`` or ``"lax"`` for one bucket.

    ``auto`` takes the CUDA kernel on a GPU whenever the bucket and matrix
    fit it (:func:`kaptive_tpu.ops.swg_cuda.fits`), else the lax path.  A
    forced ``"cuda"`` that cannot run raises: a silent lax fallback would make
    kernel-vs-lax parity checks vacuous.
    """
    from kaptive_tpu.ops import swg_cuda

    if impl not in ("auto", "lax", "cuda"):
        raise ValueError(f"unknown banded SWG impl {impl!r}")
    if impl == "lax":
        return "lax"
    fits = swg_cuda.fits(rows_max, w_pad, t_cols, compressed)
    if impl == "cuda":
        if platform != "gpu":
            raise RuntimeError(f"impl='cuda' needs a GPU; the call runs on {platform!r}")
        if not fits:
            raise ValueError(
                f"impl='cuda' forced but bucket (rows={rows_max}, w_pad={w_pad}, "
                f"t_cols={t_cols}) or matrix is outside the CUDA kernel contract"
            )
    return "cuda" if platform == "gpu" and fits else "lax"


def banded_swg(
    q_codes,
    q_lens,
    t_codes,
    t_lens,
    offsets,
    k_locals,
    matrix,
    *,
    gap_open: int,
    gap_extend: int,
    rows_max: int,
    w_pad: int,
    t_pad: int,
    impl: str = "auto",
    platform: str | None = None,
) -> SwgResult:
    r"""Banded SWG front door: the CUDA kernel on a GPU, lax elsewhere.

    ``impl`` forces ``"lax"`` or ``"cuda"``; see :func:`choose_impl`.  Both
    give identical results.  ``platform`` is that of the devices the call
    runs on (a mesh's, under ``shard_map``); the default device's when None.
    """
    from kaptive_tpu.platform import default_platform
    from kaptive_tpu.utils.metrics import count, record_shape

    record_shape("swg", rows_max, w_pad, int(q_codes.shape[0]))
    compressed = compress_matrix_cached(np.asarray(matrix)) if impl != "lax" else None
    if choose_impl(
        impl, platform or default_platform(), rows_max, w_pad, int(t_codes.shape[1]), compressed
    ) == "cuda":
        from kaptive_tpu.ops.swg_cuda import banded_swg_cuda

        count("swg.dispatch.cuda")
        row_lut, col_lut, small = compressed
        return banded_swg_cuda(
            jnp.asarray(q_codes),
            jnp.asarray(q_lens, dtype=jnp.int32),
            jnp.asarray(t_codes),
            jnp.asarray(t_lens, dtype=jnp.int32),
            jnp.asarray(offsets, dtype=jnp.int32),
            jnp.asarray(k_locals, dtype=jnp.int32),
            jnp.asarray(row_lut),
            jnp.asarray(col_lut),
            jnp.asarray(small),
            gap_open=gap_open,
            gap_extend=gap_extend,
            rows_max=rows_max,
            w_pad=w_pad,
            t_pad=t_pad,
        )
    count("swg.dispatch.lax")
    return banded_swg_lax(
        jnp.asarray(q_codes),
        jnp.asarray(q_lens, dtype=jnp.int32),
        jnp.asarray(t_codes),
        jnp.asarray(t_lens, dtype=jnp.int32),
        jnp.asarray(offsets, dtype=jnp.int32),
        jnp.asarray(k_locals, dtype=jnp.int32),
        jnp.asarray(matrix, dtype=jnp.int32),
        gap_open=gap_open,
        gap_extend=gap_extend,
        rows_max=rows_max,
        w_pad=w_pad,
        t_pad=t_pad,
    )


MAX_CIGAR_OPS = 256  # run-length op capacity per pair (overflowing pairs flag + truncate)


def _traceback_cigar(
    tb: jax.Array, q: jax.Array, t_padded: jax.Array,
    best_i: jax.Array, best_j: jax.Array, offset: jax.Array,
    w_pad: int, rows_max: int, t_pad_amount: int, cap_ops: int,
):
    r"""Traceback that additionally records BAM-encoded CIGAR runs.

    The walk moves end->start, so runs are collected in reverse and flipped at
    the end.  Op convention matches PAF/BAM for a query-vs-target alignment:
    ``M`` consumes both (match or mismatch), ``I`` consumes query only (our
    vertical D state), ``D`` consumes target only (our horizontal I state).
    Returns (matches, mismatches, gaps, q_start, t_start, ops, n_ops,
    overflowed); ops are start->end order.
    """
    k_pad = (w_pad - 3) // 2
    NO_OP = jnp.int32(-1)

    def cond(st):
        i, j, state, m, x, g, cur_op, run, ptr, ops, done = st
        return (~done) & (i > 0) & (j > 0)

    def emit(ops, ptr, cur_op, run):
        record = (run.astype(jnp.uint32) << 4) | cur_op.astype(jnp.uint32)
        do_write = cur_op != NO_OP
        ops = ops.at[jnp.where(do_write, jnp.minimum(ptr, cap_ops - 1), cap_ops - 1)].set(
            jnp.where(do_write, record, ops[jnp.minimum(ptr, cap_ops - 1)])
        )
        return ops, ptr + jnp.where(do_write, 1, 0)

    def body(st):
        i, j, state, m, x, g, cur_op, run, ptr, ops, done = st
        dmv = j - (i - offset) + k_pad + 1
        cell = tb[jnp.clip(i - 1, 0, rows_max - 1), jnp.clip(dmv, 0, w_pad - 1)].astype(jnp.int32)
        tb_m = cell & 3
        tb_d_ext = (cell >> 2) & 1
        tb_i_ext = (cell >> 3) & 1

        qc = q[jnp.clip(i - 1, 0, rows_max - 1)]
        tc = t_padded[jnp.clip(j - 1 + t_pad_amount, 0, t_padded.shape[0] - 1)]

        m_stop = (state == 0) & (tb_m == 3)
        m_diag = (state == 0) & (tb_m == 0)
        m_to_d = (state == 0) & (tb_m == 1)
        m_to_i = (state == 0) & (tb_m == 2)
        in_d = state == 1
        in_i = state == 2

        m = m + jnp.where(m_diag & (qc == tc), 1, 0)
        x = x + jnp.where(m_diag & (qc != tc), 1, 0)
        g = g + jnp.where(in_d | in_i, 1, 0)

        # BAM op for this step: M=0 on diagonal, I=1 on query gaps (our D
        # state), D=2 on target gaps (our I state); transition steps emit none.
        step_op = jnp.where(m_diag, 0, jnp.where(in_d, 1, jnp.where(in_i, 2, NO_OP)))
        advances = m_diag | in_d | in_i
        flush = advances & (step_op != cur_op)
        ops, ptr = jax.lax.cond(
            flush, lambda o, p: emit(o, p, cur_op, run), lambda o, p: (o, p), ops, ptr
        )
        run = jnp.where(flush, 1, jnp.where(advances, run + 1, run))
        cur_op = jnp.where(advances, step_op, cur_op)

        new_i = i - jnp.where(m_diag | in_d, 1, 0)
        new_j = j - jnp.where(m_diag | in_i, 1, 0)
        new_state = jnp.where(
            m_to_d, 1,
            jnp.where(
                m_to_i, 2,
                jnp.where(in_d & (tb_d_ext == 0), 0, jnp.where(in_i & (tb_i_ext == 0), 0, state)),
            ),
        )
        new_state = jnp.where(m_diag | m_stop, 0, new_state)
        done = done | m_stop
        return (new_i, new_j, new_state, m, x, g, cur_op, run, ptr, ops, done)

    init = (
        best_i, best_j, jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
        NO_OP, jnp.int32(0), jnp.int32(0),
        jnp.zeros(cap_ops, dtype=jnp.uint32), jnp.bool_(False),
    )
    i, j, _, m, x, g, cur_op, run, ptr, ops, _ = jax.lax.while_loop(cond, body, init)
    ops, ptr = emit(ops, ptr, cur_op, run)  # flush the final run
    n_ops = jnp.minimum(ptr, cap_ops)
    overflow = ptr > cap_ops
    # Runs were collected end->start; flip the valid prefix to start->end.
    idx = jnp.arange(cap_ops)
    flipped = jnp.where(idx < n_ops, ops[jnp.clip(n_ops - 1 - idx, 0, cap_ops - 1)], 0)
    return m, x, g, i, j, flipped, n_ops, overflow


@functools.partial(
    jax.jit, static_argnames=("gap_open", "gap_extend", "rows_max", "w_pad", "t_pad", "cap_ops")
)
def banded_swg_lax_cigars(
    q_codes: jax.Array, q_lens: jax.Array, t_codes: jax.Array, t_lens: jax.Array,
    offsets: jax.Array, k_locals: jax.Array, matrix: jax.Array,
    *, gap_open: int, gap_extend: int, rows_max: int, w_pad: int, t_pad: int,
    cap_ops: int = MAX_CIGAR_OPS,
):
    r"""Like :func:`banded_swg_lax` but also returns per-pair BAM CIGAR runs.

    Returns (SwgResult, ops (B, cap_ops) uint32, n_ops (B,), overflow (B,)).
    Used for the opt-in ``do_cigar`` mapper mode (the reference maps with
    ``do_cigar=True`` — ``serotyping/core.py:148`` — and ingests CIGARs at
    ``core/alignment.py:409-446``; typing decisions never read them).
    """
    q_codes = q_codes.astype(jnp.int32)
    t_codes = t_codes.astype(jnp.int32)

    def one(q, t_padded, l1, l2, off, kl):
        tb, best, bi, bj = _fill_band(
            q, t_padded, l1, l2, off, kl, matrix, gap_open, gap_extend, rows_max, w_pad
        )
        m, x, g, si, sj, ops, n_ops, overflow = _traceback_cigar(
            tb, q, t_padded, bi, bj, off, w_pad, rows_max, t_pad, cap_ops
        )
        return SwgResult(best, m, x, g, si, bi, sj, bj), ops, n_ops, overflow

    return jax.vmap(one)(q_codes, t_codes, q_lens, t_lens, offsets, k_locals)


# Host-facing helpers ---------------------------------------------------------------------------------------------------
def pad_ragged_to_matrix(
    seqs: np.ndarray, offsets: np.ndarray, lengths: np.ndarray, width: int, pad: int = 0
) -> np.ndarray:
    r"""Pack a ragged uint8 batch into a (B, width) uint8 matrix (zero-padded).

    uint8 keeps the host->device transfer 4x smaller; the kernel casts on
    device.
    """
    n = len(offsets)
    out = np.zeros((n, width), dtype=np.uint8)
    for i in range(n):
        ln = min(int(lengths[i]), width)
        out[i, :ln] = seqs[offsets[i] : offsets[i] + ln]
    return out


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
