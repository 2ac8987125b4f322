"""Packed-descriptor Hamming distance kernels and match primitives.

Replaces the reference's scalar popcount loop
(``OrbMatcher::computeDescriptorsDistance``, src/orbMatcher.cpp:11-23)
and the search scaffolding shared by its 9 matchers: best/second-best
ratio tests, mutual-best checks, and the 30-bin rotation-consistency
histogram (src/orbMatcher.cpp:827-853).

Distances are computed as dense (M, N) matrices in one shot —
XOR + ``lax.population_count`` on uint32[8] lanes, elementwise work that
XLA fuses; the gated best/second search over large M*N has a Triton
kernel in ops/best2.py.  The reference's "search in area / by
projection / by BoW node" pruning strategies all become *masks* on this matrix, which is
both simpler and a better fit for the hardware than gather-heavy
candidate lists.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

INVALID_DIST = 10_000  # sentinel > any Hamming distance (max 256)


def hamming_distance(a: jax.Array, b: jax.Array) -> jax.Array:
    """Elementwise Hamming distance between (..., 8) uint32 descriptors."""
    x = jax.lax.population_count(jnp.bitwise_xor(a, b))
    return jnp.sum(x, axis=-1).astype(jnp.int32)


@jax.jit
def distance_matrix(desc_a: jax.Array, desc_b: jax.Array) -> jax.Array:
    """(M, 8) x (N, 8) uint32 -> (M, N) int32 Hamming distances."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def masked_distance_matrix(
    desc_a: jax.Array,
    desc_b: jax.Array,
    valid_a: jax.Array,
    valid_b: jax.Array,
    pair_mask: jax.Array | None = None,
) -> jax.Array:
    """Distance matrix with invalid rows/cols/pairs set to INVALID_DIST."""
    d = distance_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    return jnp.where(mask, d, INVALID_DIST)


def best_and_second(d: jax.Array):
    """Per-row best and second-best over a (M, N) distance matrix.

    Returns (best_idx (M,), best (M,), second (M,)).  This is the
    common core of every reference search loop (e.g.
    src/orbMatcher.cpp:102-137).
    """
    neg = -d
    vals, idxs = jax.lax.top_k(neg, 2)
    return idxs[:, 0], -vals[:, 0], -vals[:, 1]


def ratio_test_matches(
    d: jax.Array,
    max_dist: int,
    ratio: float | None = None,
    mutual: bool = False,
):
    """Select matches from a distance matrix.

    Returns (match_idx (M,) int32 with -1 for no match, best_dist (M,)).
    ``ratio`` applies best < ratio * second (the reference's
    best/second test); ``mutual`` additionally requires the column's
    best row to be this row (used by searchBySim3's mutual marking,
    src/orbMatcher.cpp:566-681).
    """
    bi, b1, b2 = best_and_second(d)
    ok = b1 <= max_dist
    if ratio is not None:
        ok = ok & (b1.astype(jnp.float32) < ratio * b2.astype(jnp.float32))
    if mutual:
        col_best = jnp.argmin(d, axis=0)  # (N,)
        ok = ok & (col_best[bi] == jnp.arange(d.shape[0]))
    return jnp.where(ok, bi, -1), b1


def rotation_histogram_mask(
    angle_a: jax.Array,
    angle_b_matched: jax.Array,
    matched: jax.Array,
    n_bins: int = 30,
    keep_top: int = 3,
) -> jax.Array:
    """Rotation-consistency filter: keep matches whose angle difference
    falls in the ``keep_top`` most popular of ``n_bins`` bins.

    Vectorized equivalent of the reference's histogram +
    computeThreeMaxima (src/orbMatcher.cpp:138-153, :827-853), including
    its relative-popularity cut (bins below 10% of the best are dropped
    even within the top 3).
    """
    two_pi = 2.0 * jnp.pi
    diff = jnp.mod(angle_a - angle_b_matched, two_pi)  # [0, 2pi)
    bins = jnp.clip((diff * n_bins / two_pi).astype(jnp.int32), 0, n_bins - 1)
    counts = jnp.sum(
        jnp.where(matched[:, None], jax.nn.one_hot(bins, n_bins, dtype=jnp.int32), 0),
        axis=0,
    )
    top_counts, top_bins = jax.lax.top_k(counts, keep_top)
    # Reference drops 2nd/3rd bins with < 0.1 x the max count
    # (orbMatcher.cpp:840-851).
    keep = top_counts.astype(jnp.float32) > 0.1 * top_counts[0].astype(jnp.float32)
    keep = keep.at[0].set(top_counts[0] > 0)
    in_top = jnp.any((bins[:, None] == top_bins[None, :]) & keep[None, :], axis=-1)
    return matched & in_top


@functools.partial(jax.jit, static_argnames=("n_bins", "keep_top"))
def filter_matches_by_rotation(
    match_idx: jax.Array,
    angle_a: jax.Array,
    angle_b: jax.Array,
    n_bins: int = 30,
    keep_top: int = 3,
) -> jax.Array:
    """Apply the rotation histogram to a (M,) match-index vector."""
    matched = match_idx >= 0
    ang_b = angle_b[jnp.clip(match_idx, 0, angle_b.shape[0] - 1)]
    keep = rotation_histogram_mask(angle_a, ang_b, matched, n_bins, keep_top)
    return jnp.where(keep, match_idx, -1)
