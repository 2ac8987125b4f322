"""Keyframe-sharded place-recognition scoring.

The reference's inverted file is a single-threaded in-memory index
(src/keyFrameDatabase.cpp).  At scale, this framework's dense score
table (slam/retrieval.py) shards its KEYFRAME axis over the device
mesh: every device scores the query against its keyframe block
(presence matmul + L1 histogram distance, locally), then per-device
top-k results are all-gathered and merged — only the candidate set
crosses the interconnect, the (K, N_WORDS) histograms never move.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..slam.retrieval import RetrievalIndex


def sharded_topk_scores(
    mesh: Mesh,
    idx: RetrievalIndex,
    query_hist: jax.Array,
    k: int = 8,
):
    """-> (global kf ids (k,), scores (k,)) of the best-scoring keyframes.

    Index rows sharded over the mesh axis; query replicated; merge via
    all_gather of each shard's local top-k (k * n_devices candidates
    total — tiny — instead of gathering the full score vector).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    K = idx.hist.shape[0]
    assert K % n_dev == 0, "keyframe capacity must divide the mesh size"

    kl = min(k, K // n_dev)  # per-shard candidate count

    def local(hist, presence, valid, q):
        l1 = jnp.sum(jnp.abs(hist - q[None, :]), axis=-1)
        score = jnp.where(valid, 1.0 - 0.5 * l1, -1.0)
        vals, local_ids = jax.lax.top_k(score, kl)
        shard = jax.lax.axis_index(axis)
        gids = local_ids + shard * (K // n_dev)
        all_vals = jax.lax.all_gather(vals, axis)  # (n_dev,k)
        all_gids = jax.lax.all_gather(gids, axis)
        flat_v = all_vals.reshape(-1)
        flat_g = all_gids.reshape(-1)
        best_v, sel = jax.lax.top_k(flat_v, k)
        return flat_g[sel], best_v

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,  # outputs are replicated via all_gather+top_k
    )
    return jax.jit(fn)(idx.hist, idx.presence, idx.valid, query_hist)


def score_all_sharded(mesh: Mesh, idx: RetrievalIndex, query_hist: jax.Array):
    """Keyframe-sharded equivalent of ``retrieval.score_all``: each
    device scores its keyframe block (the (K_shard, N_WORDS) histograms
    and presence rows stay local; only the query histogram replicates),
    then the tiny (K,) results all-gather across the mesh.

    Bit-exact with score_all — the PRODUCTION loop detector calls this
    when more than one device is visible, so every downstream gate
    (min-score, covisibility accumulation, consistency groups) is
    untouched.  This is the scaled replacement of the reference's
    single-threaded inverted file (src/keyFrameDatabase.cpp:26-105).
    """
    axis = mesh.axis_names[0]
    K = idx.hist.shape[0]
    n_dev = mesh.devices.size
    assert K % n_dev == 0, "keyframe capacity must divide the mesh size"

    def local(hist, presence, valid, q):
        qp = (q > 0).astype(jnp.float32)
        common = presence @ qp
        l1 = jnp.sum(jnp.abs(hist - q[None, :]), axis=-1)
        score = 1.0 - 0.5 * l1
        common = jnp.where(valid, common, 0.0)
        score = jnp.where(valid, score, -1.0)
        common = jax.lax.all_gather(common, axis, tiled=True)
        score = jax.lax.all_gather(score, axis, tiled=True)
        return common, score

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,  # replicated via all_gather
    )
    return fn(idx.hist, idx.presence, idx.valid, query_hist)
