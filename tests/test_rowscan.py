"""Parity tests for the row-compact minimizer scan (ops/rowscan.py).

The host scan (``minimizer_scan_host``) is the oracle: the device scan must
select exactly the same (position, hash, strand) set.
Mirrors the reference's kernel-vs-container testing style
(``/root/reference/tests/test_core.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp

from kaptive_tpu.ops import rowscan as SP
from kaptive_tpu.ops.minimizer import DEFAULT_K, DEFAULT_W, minimizer_scan_host


def _decode_rows(h, a, c):
    got = set()
    for r in range(h.shape[0]):
        assert int(c[r, 0]) <= SP.SLOTS
        for s in range(SP.SLOTS):
            if h[r, s] == 0xFFFFFFFF:
                continue
            col = int(a[r, s]) & (SP.ROW - 1)
            strand = bool((int(a[r, s]) >> 7) & 1)
            got.add((r * SP.ROW + col, int(h[r, s]), strand))
    return got


def _host_set(codes):
    sel, hashes, strands = minimizer_scan_host(codes, DEFAULT_K, DEFAULT_W)
    return {(int(p), int(hashes[p]), bool(strands[p])) for p in np.flatnonzero(sel)}


def _random_stream(rng, rows):
    L = rows * SP.ROW
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.integers(0, L, max(L // 1000, 5))] = 4  # sprinkled sentinels
    codes[-64:] = 4  # sentinel tail (bucket padding)
    return codes


def test_rowcompact_xla_matches_host_scan():
    rng = np.random.default_rng(7)
    codes = _random_stream(rng, 1024)
    padded = SP.pad_codes_for_scan(codes)
    h, a, c = [np.asarray(x)[0] for x in SP.rowcompact_scan_xla(
        jnp.asarray(padded[None]), DEFAULT_K, DEFAULT_W
    )]
    assert _decode_rows(h, a, c) == _host_set(codes)


def test_rowcompact_xla_multi_contig_sentinels():
    # Contig boundaries appear as k-1 sentinel runs; selection must match.
    rng = np.random.default_rng(11)
    codes = _random_stream(rng, 512)
    for cut in (1000, 30000, 50001):
        codes[cut : cut + DEFAULT_K - 1] = 4
    padded = SP.pad_codes_for_scan(codes)
    h, a, c = [np.asarray(x)[0] for x in SP.rowcompact_scan_xla(
        jnp.asarray(padded[None]), DEFAULT_K, DEFAULT_W
    )]
    assert _decode_rows(h, a, c) == _host_set(codes)


def test_compact_lanes_reference():
    rng = np.random.default_rng(3)
    R, C = 64, 32
    sel = rng.uniform(size=(R, C)) < 0.4
    vals = rng.integers(0, 1 << 20, (R, C)).astype(np.int32)
    live, (out,), counts = jax.jit(
        lambda s, v: SP.compact_lanes(s, (v,), C, C)
    )(jnp.asarray(sel), jnp.asarray(vals))
    live, out, counts = np.asarray(live), np.asarray(out), np.asarray(counts)
    for r in range(R):
        want = vals[r][sel[r]]
        assert counts[r, 0] == len(want)
        assert np.array_equal(out[r][live[r]], want)
        assert np.array_equal(np.flatnonzero(live[r]), np.arange(len(want)))
