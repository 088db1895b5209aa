r"""Minimizer extraction on device: 2-bit k-mer packing, canonical hashing, window minimum.

Device replacement for the indexing half of the reference's wrapped
``rammappy`` (minimap2-class) mapper (``/root/reference/src/kaptive/core/genome.py:177-191``,
``serotyping/core.py:147-155``) and kin to the reference's own sketching
kernels (``core/kmers.py:822-1155``): rolling 2-bit packed k-mers, canonical
(min of forward/revcomp) representation, an invertible 32-bit integer mixer
(murmur3 finalizer — hashing is 32-bit by design; k=15 packs into 30 bits), and a ``w``-window minimum.

Everything is expressed as fixed-shape vector ops over a single flat code
array (contigs concatenated with ``k-1`` sentinel codes between them so k-mers
never span contigs): ``k`` shifted adds build forward/reverse packed k-mers,
``w`` shifted mins select window minima, a masked scatter marks minimizer
positions.  XLA fuses the whole pipeline into a few elementwise loops — this
is bandwidth-bound streaming work the VPU excels at.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from kaptive_tpu.core.seq import Sequences

# DNA byte -> 2-bit code LUT (A=0 C=1 G=2 T/U=3, else 4). Complement = 3-code.
DNA_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    DNA_CODE_LUT[_c] = _i
    DNA_CODE_LUT[_c + 32] = _i
DNA_CODE_LUT[ord("U")] = 3
DNA_CODE_LUT[ord("u")] = 3
DNA_CODE_LUT.flags.writeable = False

SENTINEL = 4  # invalid base code
UINT32_MAX = np.uint32(0xFFFFFFFF)

DEFAULT_K = 15
DEFAULT_W = 10

EXC_CAP = 1 << 15  # sparse-upload exception capacity (Ns + inter-contig sentinels)


def encode_dna(seqs: np.ndarray) -> np.ndarray:
    r"""Host-side byte->2-bit encoding (device path takes the code array)."""
    return DNA_CODE_LUT[seqs]


def bucket_length(n: int, minimum: int = 1 << 16) -> int:
    r"""Quantised allocation length: bounds jit recompilation variants.

    Power-of-two below 1 MiB; 512 KiB steps above (every device stage's cost
    is linear in the padded length, and pow2 buckets padded a 5.3 Mb genome
    58% — 512 KiB steps cap the waste at <10% while adding ~16 compiled size
    classes per order of magnitude, all persisted by the XLA compilation
    cache and warmed in parallel).  Every bucket is a multiple of the
    row-compact scan's 128-position row.
    """
    step = 1 << 19
    if n > step:
        return -(-n // step) * step
    size = minimum
    while size < n:
        size *= 2
    return size


def concat_with_sentinels(
    codes: np.ndarray, offsets: np.ndarray, lengths: np.ndarray, k: int, pad_to_bucket: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    r"""Concatenate per-sequence code arrays with ``k-1`` sentinels between them.

    Returns (flat_codes, seq_starts) where ``seq_starts[i]`` is the position of
    sequence ``i`` within the flat array.  With ``pad_to_bucket`` the flat array
    is sentinel-padded to a power-of-two length so the device minimizer scan
    compiles once per bucket instead of once per genome (sentinels yield no
    minimizers, so padding is semantically inert).
    """
    n = len(offsets)
    gap = k - 1
    total = int(lengths.sum()) + gap * max(n - 1, 0)
    alloc = bucket_length(max(total, 1)) if pad_to_bucket else total
    flat = np.full(alloc, SENTINEL, dtype=np.uint8)
    starts = np.zeros(n, dtype=np.int64)
    pos = 0
    for i in range(n):
        ln = int(lengths[i])
        starts[i] = pos
        flat[pos : pos + ln] = codes[offsets[i] : offsets[i] + ln]
        pos += ln + gap
    return flat, starts


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    r"""Pack base codes 4-per-byte for cheap host->device transfer.

    Sentinels (code 4) are packed as 0; callers reconstruct the sentinel mask
    on device from the bit-packed validity mask (:func:`unpack_2bit_with_bits`).
    Length must be a multiple of 4 (bucket padding guarantees this).
    """
    clean = np.where(codes < 4, codes, 0).astype(np.uint8)
    quads = clean.reshape(-1, 4)
    return (
        quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
    ).astype(np.uint8)


def pack_valid_bits(codes: np.ndarray) -> np.ndarray:
    r"""Bit-pack the validity mask (code < 4) 8 positions per byte (LSB first)."""
    valid = (codes < SENTINEL).astype(np.uint8)
    return np.packbits(valid.reshape(-1, 8), axis=-1, bitorder="little").reshape(-1)


def unpack_2bit_with_bits(packed: jax.Array, valid_bits: jax.Array, length: int) -> jax.Array:
    r"""Device-side unpack: 2-bit codes + bit-packed validity mask -> code array.

    Pure shift/stack/reshape work — no per-position searches — so XLA lowers it
    to a few fused elementwise passes.
    """
    p = packed.astype(jnp.uint8)
    quads = jnp.stack(
        [p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3], axis=-1
    ).reshape(length)
    vb = valid_bits.astype(jnp.uint8)
    bits = jnp.stack([(vb >> i) & 1 for i in range(8)], axis=-1).reshape(length)
    return jnp.where(bits == 1, quads, SENTINEL).astype(jnp.uint8)


def _mix32(x: jax.Array) -> jax.Array:
    r"""murmur3 32-bit finalizer — invertible avalanche mixer."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> jnp.uint32(16))
    return x


@functools.partial(jax.jit, static_argnames=("k", "w"))
def minimizer_scan(codes: jax.Array, k: int = DEFAULT_K, w: int = DEFAULT_W):
    r"""Compute minimizer selection over a flat code array.

    Args:
        codes: (L,) uint8/int32 base codes (0-3 valid, >=4 sentinel).

    Returns:
        (selected, hashes, strands):
        ``selected`` (L,) bool — position starts a selected minimizer k-mer;
        ``hashes`` (L,) uint32 — canonical k-mer hash at each position
        (UINT32_MAX where invalid); ``strands`` (L,) bool — True when the
        forward packing was the canonical one.
    """
    L = codes.shape[0]
    c = codes.astype(jnp.uint32)
    bad = (c >= SENTINEL).astype(jnp.int32)

    # Packed forward/reverse k-mers via k shifted adds (static unroll).
    fwd = jnp.zeros(L, dtype=jnp.uint32)
    rev = jnp.zeros(L, dtype=jnp.uint32)
    badsum = jnp.zeros(L, dtype=jnp.int32)
    for j in range(k):
        cj = jnp.roll(c, -j)  # codes[i + j]
        fwd = fwd | (cj << jnp.uint32(2 * (k - 1 - j)))
        rev = rev | ((jnp.uint32(3) - cj) << jnp.uint32(2 * j))
        badsum = badsum + jnp.roll(bad, -j)
    valid = (badsum == 0) & (jnp.arange(L) < L - k + 1)

    canonical = jnp.minimum(fwd, rev)
    strands = fwd <= rev
    hashes = jnp.where(valid, _mix32(canonical), UINT32_MAX)

    # Window minimum over w consecutive k-mer starts; leftmost-on-tie.
    best = hashes
    best_pos = jnp.arange(L, dtype=jnp.int32)
    for j in range(1, w):
        cand = jnp.roll(hashes, -j)
        cand_pos = jnp.arange(L, dtype=jnp.int32) + j
        take = cand < best
        best = jnp.where(take, cand, best)
        best_pos = jnp.where(take, cand_pos, best_pos)
    window_valid = (best != UINT32_MAX) & (jnp.arange(L) < L - k - w + 2)

    # Position p is a minimizer iff some window starting in (p-w, p] picked it.
    # Expressed as w shifted compares (unrolled: XLA fuses the OR chain into a
    # couple of passes); a scatter here would serialise on colliding
    # indices.  Callers bound peak memory by
    # sequencing the batch axis (lax.map in the mapper).
    pos_idx = jnp.arange(L, dtype=jnp.int32)
    delta = jnp.where(window_valid, best_pos - pos_idx, -1)  # in [0, w) when valid
    selected = delta == 0
    for d in range(1, w):
        selected |= jnp.roll(delta == d, d) & (pos_idx >= d)
    selected = selected & valid
    return selected, hashes, strands


def minimizer_scan_host(codes: np.ndarray, k: int = DEFAULT_K, w: int = DEFAULT_W):
    r"""Numpy mirror of :func:`minimizer_scan` for host-side / offline use.

    Used for the one-time DB gene-table build (no device round-trip needed)
    and as a CPU fallback; produces identical (selected, hashes, strands).
    """
    L = len(codes)
    c = codes.astype(np.uint32)
    bad = (c >= SENTINEL).astype(np.int32)
    fwd = np.zeros(L, dtype=np.uint32)
    rev = np.zeros(L, dtype=np.uint32)
    badsum = np.zeros(L, dtype=np.int32)
    for j in range(k):
        cj = np.roll(c, -j)
        fwd |= cj << np.uint32(2 * (k - 1 - j))
        rev |= (np.uint32(3) - cj) << np.uint32(2 * j)
        badsum += np.roll(bad, -j)
    valid = (badsum == 0) & (np.arange(L) < L - k + 1)
    canonical = np.minimum(fwd, rev)
    strands = fwd <= rev
    # murmur3 finalizer (same as device _mix32)
    x = canonical.copy()
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    hashes = np.where(valid, x, UINT32_MAX)

    best = hashes.copy()
    best_pos = np.arange(L, dtype=np.int32)
    for j in range(1, w):
        cand = np.roll(hashes, -j)
        cand_pos = np.arange(L, dtype=np.int32) + j
        take = cand < best
        best = np.where(take, cand, best)
        best_pos = np.where(take, cand_pos, best_pos)
    window_valid = (best != UINT32_MAX) & (np.arange(L) < L - k - w + 2)
    selected = np.zeros(L, dtype=bool)
    selected[best_pos[window_valid]] = True
    selected &= valid
    return selected, hashes, strands


@dataclass(frozen=True, slots=True)
class MinimizerSet:
    r"""Compacted minimizers of a sequence batch, with a sorted lookup table."""

    hashes: np.ndarray  # (N,) uint32, sorted ascending
    seq_indices: np.ndarray  # (N,) int32
    positions: np.ndarray  # (N,) int32 position within the sequence
    strands: np.ndarray  # (N,) bool — forward packing was canonical
    n_seqs: int
    k: int
    w: int


def build_minimizer_set(
    seqs: Sequences, k: int = DEFAULT_K, w: int = DEFAULT_W, sort: bool = True, device: bool = False
) -> MinimizerSet:
    r"""Extract and (optionally) hash-sort minimizers for a ragged sequence batch.

    Defaults to the host scan: this builder produces *compacted* record arrays
    consumed on host (DB gene tables, per-contig records), and full-length
    device->host transfers would dominate.  The device path
    (:func:`minimizer_scan`) is used by the fused on-device mapping pipeline
    which keeps data resident and transfers only anchors.
    """
    if len(seqs) == 0 or len(seqs.seqs) == 0:
        e = np.empty(0)
        return MinimizerSet(
            e.astype(np.uint32), e.astype(np.int32), e.astype(np.int32), e.astype(bool), 0, k, w
        )
    codes = encode_dna(seqs.seqs)
    flat, starts = concat_with_sentinels(codes, seqs.offsets, seqs.lengths, k)
    if device:
        sel, hashes, strands = jax.tree.map(np.asarray, minimizer_scan(jnp.asarray(flat), k, w))
    else:
        sel, hashes, strands = minimizer_scan_host(flat, k, w)
    pos = np.flatnonzero(sel)
    h = hashes[pos]
    st = strands[pos]
    # Map flat positions back to (seq, local pos).
    seq_idx = np.searchsorted(starts, pos, side="right").astype(np.int32) - 1
    local = (pos - starts[seq_idx]).astype(np.int32)
    if sort:
        order = np.argsort(h, kind="stable")
        h, seq_idx, local, st = h[order], seq_idx[order], local[order], st[order]
    return MinimizerSet(h.astype(np.uint32), seq_idx, local, st.astype(bool), len(seqs), k, w)


@dataclass(frozen=True, slots=True)
class ContigIndex:
    r"""Per-assembly mapping index: encoded contigs (+ lazily computed minimizers).

    The device stand-in for the reference's lazily-built rammappy index
    (``genome.py:177-191``): holds the flat 2-bit encoding; minimizer
    extraction happens inside the fused on-device mapping step
    (:func:`kaptive_tpu.ops.mapper.scan_match`), which keeps the full-length
    scan arrays device-resident and transfers only compacted anchors.  A host
    :class:`MinimizerSet` is still available lazily for host-side consumers.
    """

    codes: np.ndarray  # flat encoded contigs (with sentinels, bucket-padded)
    starts: np.ndarray  # (n_contigs,) start of each contig within codes
    lengths: np.ndarray  # (n_contigs,)
    k: int
    w: int
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def build(cls, contigs: Sequences, k: int = DEFAULT_K, w: int = DEFAULT_W) -> "ContigIndex":
        gap = k - 1
        starts = np.zeros(len(contigs.offsets), dtype=np.int64)
        if len(starts) > 1:
            np.cumsum(contigs.lengths[:-1].astype(np.int64) + gap, out=starts[1:])
        try:
            # Native fused path: encode + sentinel-concat + 2-bit pack +
            # exception scan in one C pass; the pack/exception outputs seed
            # the sparse-upload cache so the ingest threads skip the numpy
            # pack entirely.
            from kaptive_tpu.native import hostio

            n = len(contigs.offsets)
            total = int(contigs.lengths.sum()) + gap * max(n - 1, 0)
            alloc = bucket_length(max(total, 1))
            flat, packed, exc, real, n_exc = hostio.build_contig_stream(
                contigs.seqs, contigs.offsets, contigs.lengths, gap, alloc, EXC_CAP
            )
            ci = cls(flat, starts, contigs.lengths.astype(np.int64), k, w)
            ci._cache["native_pack"] = (packed, exc, real, n_exc)
            return ci
        except ImportError:
            codes = encode_dna(contigs.seqs)
            flat, _ = concat_with_sentinels(codes, contigs.offsets, contigs.lengths, k)
            return cls(flat, starts, contigs.lengths.astype(np.int64), k, w)

    @property
    def minimizers(self) -> MinimizerSet:
        r"""Host minimizer set over the flat contig stream (lazy)."""
        if "mins" not in self._cache:
            sel, hashes, strands = minimizer_scan_host(self.codes, self.k, self.w)
            pos = np.flatnonzero(sel)
            seq_idx = np.searchsorted(self.starts, pos, side="right").astype(np.int32) - 1
            local = (pos - self.starts[seq_idx]).astype(np.int32)
            self._cache["mins"] = MinimizerSet(
                hashes[pos].astype(np.uint32), seq_idx, local,
                strands[pos].astype(bool), len(self.starts), self.k, self.w,
            )
        return self._cache["mins"]

    @property
    def device_codes(self):
        r"""Cached device copy of the flat code stream."""
        if "dev" not in self._cache:
            self._cache["dev"] = jnp.asarray(self.codes)
        return self._cache["dev"]
