"""Place-recognition retrieval: the DBoW3 vocabulary-tree replacement.

The reference scores BoW vectors from a 10^5-word hierarchical k-means
vocabulary (thirdParty/DBow3, loaded from ORBvoc.txt at startup,
src/system.cpp:37-38) through an inverted file
(src/keyFrameDatabase.cpp).  A vocabulary file does not exist here and a
tree walk is a poor fit for dense batched scoring, so the design is
vocabulary-free multi-bank LSH:

  * each 256-bit descriptor hashes into H=4 banks of 4096 words (12
    sampled bit positions per bank, fixed seed; 16k words total, the
    same order as DBoW3's default 10^5-word tree relative to frame
    size) — similar descriptors collide far above chance, dissimilar
    ones at ~1/4096 per bank;
  * a keyframe is a dense (H*256,) tf histogram + word-presence bitmap;
  * "common words" = presence AND-count, one matmul over all keyframes;
  * similarity = L1 BoW score s(v,w) = 1 - 0.5*|v/|v| - w/|w||_1 —
    identical to DBoW3's L1 scoring (ScoringObject.cpp) — computed
    dense against every keyframe at once (no inverted file: the full
    score table is one batched pass, and shards over devices by
    keyframe block).

Candidate gating reproduces KeyFrameDatabase::detectLoopCandidates /
detectRelocalizationCandidates (keyFrameDatabase.cpp:26-180): exclude
covisibles, >= 0.8 x max common words, score >= minScore,
covisibility-group score accumulation, keep > 0.75 x best.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

N_BANKS = 4  # default bank geometry (config: loop.retrieval_banks)
BANK_BITS = 12  # config: loop.retrieval_bank_bits
N_WORDS = N_BANKS * (1 << BANK_BITS)  # 16384


@functools.lru_cache()
def _hash_bit_positions(n_banks: int = N_BANKS, bank_bits: int = BANK_BITS) -> np.ndarray:
    """(n_banks, bank_bits) fixed random bit indices into the 256 bits."""
    rs = np.random.RandomState(0x10C4)
    return np.stack(
        [rs.choice(256, bank_bits, replace=False) for _ in range(n_banks)]
    ).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("n_banks", "bank_bits"))
def descriptor_words(
    desc: jax.Array, n_banks: int = N_BANKS, bank_bits: int = BANK_BITS
) -> jax.Array:
    """(N, 8) uint32 packed descriptors -> (N, n_banks) int32 word ids."""
    pos = jnp.asarray(_hash_bit_positions(n_banks, bank_bits))  # (H,B)
    lane = pos // 32
    bit = pos % 32
    bits = (desc[:, lane] >> bit.astype(jnp.uint32)) & 1  # (N,H,B)
    weights = (1 << jnp.arange(bank_bits, dtype=jnp.uint32))[None, None, :]
    word = jnp.sum(bits * weights, axis=-1).astype(jnp.int32)  # (N,H)
    offset = (jnp.arange(n_banks, dtype=jnp.int32) << bank_bits)[None, :]
    return word + offset


@functools.partial(jax.jit, static_argnames=("n_banks", "bank_bits"))
def bow_histogram(
    desc: jax.Array, valid: jax.Array,
    n_banks: int = N_BANKS, bank_bits: int = BANK_BITS,
) -> jax.Array:
    """(N,8)+(N,) -> (n_words,) L1-normalized tf histogram."""
    n_words = n_banks * (1 << bank_bits)
    words = descriptor_words(desc, n_banks, bank_bits)  # (N,H)
    w = jnp.where(valid[:, None], words, n_words)  # invalid -> overflow bin
    hist = jnp.zeros((n_words + 1,)).at[w.reshape(-1)].add(1.0)[:n_words]
    return hist / jnp.maximum(hist.sum(), 1e-6)


class RetrievalIndex(NamedTuple):
    """Per-keyframe BoW state, device-resident (K, n_words)."""

    hist: jax.Array  # (K, n_words) f32 normalized tf
    presence: jax.Array  # (K, n_words) f32 0/1
    valid: jax.Array  # (K,) bool


def empty_index(
    K: int, n_banks: int = N_BANKS, bank_bits: int = BANK_BITS
) -> RetrievalIndex:
    n_words = n_banks * (1 << bank_bits)
    return RetrievalIndex(
        hist=jnp.zeros((K, n_words)),
        presence=jnp.zeros((K, n_words)),
        valid=jnp.zeros((K,), bool),
    )


@functools.partial(
    jax.jit, static_argnames=("n_banks", "bank_bits"), donate_argnums=(0,)
)
def add_keyframe(
    idx: RetrievalIndex, kf_id, desc: jax.Array, kp_valid: jax.Array,
    n_banks: int = N_BANKS, bank_bits: int = BANK_BITS,
) -> RetrievalIndex:
    h = bow_histogram(desc, kp_valid, n_banks, bank_bits)
    return RetrievalIndex(
        hist=idx.hist.at[kf_id].set(h),
        presence=idx.presence.at[kf_id].set((h > 0).astype(jnp.float32)),
        valid=idx.valid.at[kf_id].set(True),
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def remove_keyframes(idx: RetrievalIndex, kf_ids: jax.Array) -> RetrievalIndex:
    """Batched KeyFrameDatabase::erase: clear every id in ``kf_ids``
    ((R,) i32, -1 padded) with ONE dispatch — keyframe culling erases a
    handful of entries at once and per-id dispatches cost a host round
    trip each."""
    K = idx.valid.shape[0]
    rows = jnp.where(kf_ids >= 0, kf_ids, K)  # -1 -> dropped row
    return RetrievalIndex(
        hist=idx.hist.at[rows].set(0.0, mode="drop"),
        presence=idx.presence.at[rows].set(0.0, mode="drop"),
        valid=idx.valid.at[rows].set(False, mode="drop"),
    )


def remove_keyframe(idx: RetrievalIndex, kf_id) -> RetrievalIndex:
    return remove_keyframes(idx, jnp.asarray([kf_id], jnp.int32))


@jax.jit
def score_all(idx: RetrievalIndex, query_hist: jax.Array):
    """-> (common_words (K,), l1_score (K,)) of the query vs every KF.

    common words as a presence matmul; L1 score via
    sum(min(v,w)) = 0.5*(|v|+|w|-|v-w|) = 1 - 0.5*|v-w| for normalized
    histograms (DBoW3 L1 scoring).
    """
    qp = (query_hist > 0).astype(jnp.float32)
    common = idx.presence @ qp  # (K,)
    l1 = jnp.sum(jnp.abs(idx.hist - query_hist[None, :]), axis=-1)
    score = 1.0 - 0.5 * l1
    return (
        jnp.where(idx.valid, common, 0.0),
        jnp.where(idx.valid, score, -1.0),
    )


@functools.partial(jax.jit, static_argnames=("max_out",))
def detect_candidates(
    idx: RetrievalIndex,
    query_hist: jax.Array,
    connected: jax.Array,  # (K,) bool: covisible group of the query (excluded)
    covis: jax.Array,  # (K,K) i32 covisibility weights (for group scores)
    min_score: jax.Array,  # scalar gate (loop: min covis score; reloc: 0)
    max_out: int = 8,
):
    """Gated candidate detection (keyFrameDatabase.cpp:26-105).

    Returns (candidate kf ids (max_out,) padded -1, their accumulated
    group scores).
    """
    common, score = score_all(idx, query_hist)
    eligible = idx.valid & ~connected
    common = jnp.where(eligible, common, 0.0)
    max_common = jnp.max(common)
    ok = eligible & (common > 0.8 * max_common) & (score >= min_score) & (
        common > 0
    )
    base = jnp.where(ok, score, 0.0)
    # Group accumulation: each candidate accumulates the scores of its
    # top-10 covisible neighbors that are also candidates.
    K = covis.shape[0]
    top_w, top_i = jax.lax.top_k(covis, min(10, K))  # (K,10)
    neigh_scores = jnp.where(top_w > 0, base[top_i], 0.0)
    acc = base + jnp.sum(neigh_scores, axis=-1)  # (K,)
    acc = jnp.where(ok, acc, -1.0)
    best_acc = jnp.max(acc)
    keep = ok & (acc > 0.75 * best_acc)
    ranked = jnp.where(keep, acc, -1.0)
    vals, ids = jax.lax.top_k(ranked, max_out)
    return jnp.where(vals > 0, ids, -1), vals
