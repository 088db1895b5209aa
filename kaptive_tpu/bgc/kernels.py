r"""JAX kernels for BGC featurisation, smoothing, emissions, and Viterbi decoding.

Capability parity with ``/root/reference/src/kaptive/bgc/kernels.py``:
``vectorize_orfs_kernel`` (:24-61, L2-normalised bag-of-strobemer histogram),
``contextualize_features_kernel`` (:64-93, sliding window mean),
``archetype_emissions_kernel`` (:96-145, negative squared distance emissions +
novelty state), ``architectural_viterbi_kernel`` (:148-203, max-plus DP with
forced POST termination).

Device design: the histogram is a scatter-add, smoothing is a prefix-sum
window mean, emissions are one ``(N,D)x(D,K)`` matmul via the squared-distance
expansion, and Viterbi is a ``lax.scan`` over ORFs with a vectorised
max-plus step and backpointer gather — no per-cell Python.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp


def compute_record_offsets(seq_indices: np.ndarray, num_seqs: int) -> np.ndarray:
    r"""Per-sequence start offsets into (seq-ordered) strobemer records (ref kmers :1158-1184)."""
    return np.searchsorted(seq_indices, np.arange(num_seqs + 1)).astype(np.int64)


def vectorize_orfs(
    hashes: np.ndarray, seq_indices: np.ndarray, num_seqs: int, feature_dim: int
) -> np.ndarray:
    r"""L2-normalised bag-of-strobemer feature matrix (N, D) via scatter-add."""
    if num_seqs == 0:
        return np.zeros((0, feature_dim), dtype=np.float32)
    rows = np.asarray(seq_indices, dtype=np.int64)
    cols = (np.asarray(hashes, dtype=np.uint64) % np.uint64(feature_dim)).astype(np.int64)
    feats = np.zeros((num_seqs, feature_dim), dtype=np.float32)
    np.add.at(feats, (rows, cols), 1.0)
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    return np.divide(feats, norms, out=feats, where=norms > 0)


@functools.partial(jax.jit, static_argnames=("window_size",))
def contextualize_features(features: jax.Array, window_size: int) -> jax.Array:
    r"""Sliding-window mean over adjacent ORFs via prefix sums."""
    n, d = features.shape
    cs = jnp.concatenate([jnp.zeros((1, d), features.dtype), jnp.cumsum(features, axis=0)])
    idx = jnp.arange(n)
    lo = jnp.maximum(idx - window_size, 0)
    hi = jnp.minimum(idx + window_size + 1, n)
    sums = cs[hi] - cs[lo]
    return sums / (hi - lo)[:, None].astype(features.dtype)


@jax.jit
def archetype_emissions(
    features: jax.Array, centroids: jax.Array, bg_centroid: jax.Array, novelty_score: float
) -> jax.Array:
    r"""Log-emissions (N, K+3): background, K archetypes, NOVEL, POST — matmul distance expansion."""
    n = features.shape[0]
    k = centroids.shape[0]
    # -||x - c||^2 = -(|x|^2 - 2 x.c + |c|^2)
    x2 = jnp.sum(features * features, axis=1, keepdims=True)
    c2 = jnp.sum(centroids * centroids, axis=1)[None, :]
    xc = jnp.dot(features, centroids.T, preferred_element_type=jnp.float32)
    arche = -(x2 - 2.0 * xc + c2)
    bg = -jnp.sum((features - bg_centroid[None, :]) ** 2, axis=1)
    emissions = jnp.concatenate(
        [
            bg[:, None],  # PRE
            arche,  # archetypes 1..K
            jnp.full((n, 1), novelty_score, dtype=jnp.float32),  # NOVEL
            bg[:, None],  # POST
        ],
        axis=1,
    )
    return emissions.astype(jnp.float32)


@jax.jit
def architectural_viterbi(emissions: jax.Array, transitions: jax.Array):
    r"""Max-plus Viterbi over ORF emission rows; forced termination in POST.

    Returns (path int32 (N,), max log-probability scalar).
    """
    n_states = transitions.shape[0]

    def step(prev, em_row):
        # scores[s] = max_prev(prev[p] + T[p, s]) + em[s]
        cand = prev[:, None] + transitions
        best_prev = jnp.argmax(cand, axis=0)
        cur = jnp.max(cand, axis=0) + em_row
        return cur, best_prev

    init = transitions[0] + emissions[0]
    last, backptrs = jax.lax.scan(step, init, emissions[1:])

    max_prob = last[n_states - 1]

    def back(state, bp_row):
        prev = bp_row[state]
        return prev, prev

    _, rev_path = jax.lax.scan(back, jnp.int32(n_states - 1), backptrs, reverse=True)
    path = jnp.concatenate([rev_path, jnp.array([n_states - 1], dtype=jnp.int32)])
    return path, max_prob


def architectural_viterbi_host(emissions: np.ndarray, transitions: np.ndarray):
    r"""Host wrapper handling the empty case and numpy I/O."""
    if emissions.shape[0] == 0:
        return np.zeros(0, dtype=np.int32), float("-inf")
    if emissions.shape[0] == 1:
        scores = transitions[0] + emissions[0]
        return np.array([transitions.shape[0] - 1], dtype=np.int32), float(
            scores[transitions.shape[0] - 1]
        )
    path, prob = architectural_viterbi(jnp.asarray(emissions), jnp.asarray(transitions))
    return np.asarray(path), float(prob)
