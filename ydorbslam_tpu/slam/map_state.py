"""The map as a struct-of-arrays pytree: keyframes, points, graphs.

Replaces the reference's pointer-web map model — ``Map`` (src/map.hpp),
``KeyFrame`` (src/keyFrame.hpp: covisibility graph, spanning tree, loop
edges), ``MapPoint`` (src/mapPoint.hpp: observation dict, distinctive
descriptor, normal/depth band, found/visible counters) — and its ~20
mutexes (SURVEY.md §2c P5) with ONE immutable fixed-capacity pytree of
device arrays.  Every mutation is a pure function MapState -> MapState
built from scatter/segment ops; there is nothing to lock.

Capacity conventions: K keyframe slots, N keypoint slots per keyframe,
M map-point slots, O observation slots per point.  Invalid/-empty is
``valid == False`` / index ``-1``.  Slot allocation is functional: free
slots are ranked with a cumsum and new entities scatter into the first
free ranks — no host round-trip.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics, backproject
from ..ops.extractor import FrameFeatures
from ..ops.hamming import distance_matrix


class MapState(NamedTuple):
    # --- keyframes (K, ...) ---
    kf_pose: jax.Array  # (K,4,4) T_cw
    kf_valid: jax.Array  # (K,) bool
    kf_timestamp: jax.Array  # (K,) f32
    kf_frame_id: jax.Array  # (K,) i32 source frame index (id ordering)
    kf_uv: jax.Array  # (K,N,2) undistorted
    kf_right_u: jax.Array  # (K,N)
    kf_depth: jax.Array  # (K,N)
    kf_octave: jax.Array  # (K,N) i32
    kf_angle: jax.Array  # (K,N)
    kf_desc: jax.Array  # (K,N,8) u32
    kf_kp_valid: jax.Array  # (K,N) bool
    kf_mp: jax.Array  # (K,N) i32 map-point id per keypoint slot (-1)
    # --- map points (M, ...) ---
    mp_pos: jax.Array  # (M,3)
    mp_valid: jax.Array  # (M,) bool
    mp_desc: jax.Array  # (M,8) u32 distinctive descriptor
    mp_normal: jax.Array  # (M,3) viewing normal
    mp_min_dist: jax.Array  # (M,)
    mp_max_dist: jax.Array  # (M,)
    mp_ref_kf: jax.Array  # (M,) i32
    mp_first_kf: jax.Array  # (M,) i32
    mp_found: jax.Array  # (M,) i32
    mp_visible: jax.Array  # (M,) i32
    mp_obs_kf: jax.Array  # (M,O) i32 observing keyframe (-1 empty)
    mp_obs_kp: jax.Array  # (M,O) i32 keypoint slot in that keyframe
    mp_obs_oct: jax.Array  # (M,O) i32 octave of that keypoint (denormalized
    # copy of kf_octave[obs_kf, obs_kp], maintained at add time so the
    # keyframe-culling scale test never needs a K*N-sized gather; stale
    # values behind obs_kf == -1 slots are never read)
    mp_obs_stereo: jax.Array  # (M,O) bool: observation has a stereo
    # right-x measurement (denormalized kf_right_u[obs_kf, obs_kp] >= 0,
    # maintained at add time).  The reference counts a stereo/RGB-D
    # observation as TWO in observationsNum (mapPoint.cpp:96-99) — the
    # weighted count is what the recent-point cull and trackedMapPoints
    # gates compare against; an RGB-D seed (one stereo obs = 2) survives
    # the age-2 obs<=3 cull after a single follow-up keyframe.
    # --- graph (K, ...) ---
    covis: jax.Array  # (K,K) i32 shared-point weights
    parent: jax.Array  # (K,) i32 spanning-tree parent (-1 root)
    loop_edge: jax.Array  # (K,) i32 loop edge partner (-1)
    kf_T_c2p: jax.Array  # (K,4,4) pose relative to parent, frozen at cull
    # time (reference m_cvMat_T_c2p, used by the trajectory writer to
    # walk past culled reference keyframes, src/system.cpp:209-232)

    @property
    def K(self):
        return self.kf_pose.shape[0]

    @property
    def N(self):
        return self.kf_uv.shape[1]

    @property
    def M(self):
        return self.mp_pos.shape[0]

    @property
    def O(self):
        return self.mp_obs_kf.shape[1]


def empty_map(K: int, N: int, M: int, O: int) -> MapState:
    return MapState(
        kf_pose=jnp.tile(jnp.eye(4)[None], (K, 1, 1)),
        kf_valid=jnp.zeros((K,), bool),
        kf_timestamp=jnp.zeros((K,)),
        kf_frame_id=-jnp.ones((K,), jnp.int32),
        kf_uv=jnp.zeros((K, N, 2)),
        kf_right_u=-jnp.ones((K, N)),
        kf_depth=-jnp.ones((K, N)),
        kf_octave=jnp.zeros((K, N), jnp.int32),
        kf_angle=jnp.zeros((K, N)),
        kf_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_kp_valid=jnp.zeros((K, N), bool),
        kf_mp=-jnp.ones((K, N), jnp.int32),
        mp_pos=jnp.zeros((M, 3)),
        mp_valid=jnp.zeros((M,), bool),
        mp_desc=jnp.zeros((M, 8), jnp.uint32),
        mp_normal=jnp.zeros((M, 3)),
        mp_min_dist=jnp.zeros((M,)),
        mp_max_dist=jnp.zeros((M,)),
        mp_ref_kf=-jnp.ones((M,), jnp.int32),
        mp_first_kf=-jnp.ones((M,), jnp.int32),
        mp_found=jnp.ones((M,), jnp.int32),
        mp_visible=jnp.ones((M,), jnp.int32),
        mp_obs_kf=-jnp.ones((M, O), jnp.int32),
        mp_obs_kp=-jnp.ones((M, O), jnp.int32),
        mp_obs_oct=jnp.zeros((M, O), jnp.int32),
        mp_obs_stereo=jnp.zeros((M, O), bool),
        covis=jnp.zeros((K, K), jnp.int32),
        parent=-jnp.ones((K,), jnp.int32),
        loop_edge=-jnp.ones((K,), jnp.int32),
        kf_T_c2p=jnp.tile(jnp.eye(4)[None], (K, 1, 1)),
    )


# ----------------------------------------------------------------------
# Functional slot allocation
# ----------------------------------------------------------------------

def rank_free_slots(valid: jax.Array) -> jax.Array:
    """rank[i] = how many free slots precede free slot i (for allocation)."""
    free = ~valid
    return jnp.where(free, jnp.cumsum(free) - 1, -1)


def alloc_slots(valid: jax.Array, want: jax.Array) -> jax.Array:
    """Map each requested rank r in ``want`` (int, -1 = no request) to the
    r-th free slot index, or -1 if out of capacity."""
    rank = rank_free_slots(valid)  # (M,)
    n_slots = valid.shape[0]
    # slot_of_rank[r] = index of r-th free slot.  Occupied slots have
    # rank -1 and MUST be routed out of bounds (dropped): clipping them
    # to 0 made every occupied slot overwrite slot_of_rank[0], handing
    # rank-0 allocations an already-occupied slot.
    slot_of_rank = jnp.full((n_slots,), -1, jnp.int32)
    slot_of_rank = slot_of_rank.at[jnp.where(rank >= 0, rank, n_slots)].set(
        jnp.arange(n_slots, dtype=jnp.int32), mode="drop"
    )
    slot_of_rank = jnp.where(
        jnp.arange(n_slots) < jnp.sum(~valid), slot_of_rank, -1
    )
    return jnp.where(
        (want >= 0) & (want < n_slots), slot_of_rank[jnp.clip(want, 0, n_slots - 1)], -1
    )


# ----------------------------------------------------------------------
# Observation management
# ----------------------------------------------------------------------

def obs_has_free(m: MapState, mp_ids: jax.Array) -> jax.Array:
    """(B,) whether each point has a free observation slot.  Callers
    that bind keypoints (kf_mp) must gate on this BEFORE binding so the
    invariant "every binding has an obs entry" holds — map-point culling
    clears bindings through the obs lists."""
    return jnp.any(m.mp_obs_kf[jnp.clip(mp_ids, 0, m.M - 1)] < 0, axis=-1)


def add_observations(
    m: MapState, mp_ids: jax.Array, kf_id, kp_idx: jax.Array, valid: jax.Array
) -> MapState:
    """Append (kf_id, kp) observations to points ``mp_ids`` (one obs per
    point max — callers pass unique assignments).

    MapPoint::addObservation (src/mapPoint.cpp) as a scatter: the new
    observation lands in the first free O-slot of each point; if a point
    is at capacity the observation is dropped (capped-obs policy).
    """
    mp = jnp.clip(mp_ids, 0, m.M - 1)
    slots_free = m.mp_obs_kf[mp] < 0  # (B,O)
    first_free = jnp.argmax(slots_free, axis=-1)
    has_free = jnp.any(slots_free, axis=-1)
    ok = valid & (mp_ids >= 0) & has_free
    mp_w = jnp.where(ok, mp, m.M - 1)  # writes to dummy row get masked
    obs_kf = m.mp_obs_kf.at[mp_w, first_free].set(
        jnp.where(ok, jnp.int32(kf_id), m.mp_obs_kf[mp_w, first_free]), mode="drop"
    )
    obs_kp = m.mp_obs_kp.at[mp_w, first_free].set(
        jnp.where(ok, kp_idx.astype(jnp.int32), m.mp_obs_kp[mp_w, first_free]),
        mode="drop",
    )
    oct_new = m.kf_octave[kf_id][jnp.clip(kp_idx, 0, m.N - 1)]
    obs_oct = m.mp_obs_oct.at[mp_w, first_free].set(
        jnp.where(ok, oct_new.astype(jnp.int32), m.mp_obs_oct[mp_w, first_free]),
        mode="drop",
    )
    st_new = m.kf_right_u[kf_id][jnp.clip(kp_idx, 0, m.N - 1)] >= 0
    obs_st = m.mp_obs_stereo.at[mp_w, first_free].set(
        jnp.where(ok, st_new, m.mp_obs_stereo[mp_w, first_free]), mode="drop"
    )
    return m._replace(
        mp_obs_kf=obs_kf, mp_obs_kp=obs_kp, mp_obs_oct=obs_oct,
        mp_obs_stereo=obs_st,
    )


def add_observations_multi(
    m: MapState,
    mp_ids: jax.Array,
    kf_ids: jax.Array,
    kp_idx: jax.Array,
    valid: jax.Array,
) -> MapState:
    """Append observations where the SAME point may appear several times
    in one batch (e.g. batched fusion adds one point to many keyframes).

    ``add_observations`` assigns every new obs to its point's first free
    slot — duplicates would collide.  Here each point's new observations
    are ranked (sort by point id; rank = position within the group) and
    the r-th one lands in the r-th free slot of that point's row.
    """
    F = mp_ids.shape[0]
    ok = valid & (mp_ids >= 0)
    mp = jnp.clip(mp_ids, 0, m.M - 1)
    # Rank of each entry within its point group, via one stable sort.
    order = jnp.argsort(jnp.where(ok, mp, m.M), stable=True)
    sorted_mp = jnp.where(ok, mp, m.M)[order]
    newgrp = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_mp[1:] != sorted_mp[:-1]]
    )
    pos = jnp.arange(F)
    grp_start = jnp.where(newgrp, pos, 0)
    grp_start = jax.lax.associative_scan(jnp.maximum, grp_start)
    rank_sorted = pos - grp_start
    rank = jnp.zeros((F,), jnp.int32).at[order].set(rank_sorted.astype(jnp.int32))
    # r-th free slot of each point's obs row.
    free = m.mp_obs_kf[mp] < 0  # (F,O)
    cum = jnp.cumsum(free, axis=-1)
    slot_hit = free & (cum == (rank[:, None] + 1))
    slot = jnp.argmax(slot_hit, axis=-1)  # (F,)
    has_slot = jnp.any(slot_hit, axis=-1)
    okw = ok & has_slot
    mp_w = jnp.where(okw, mp, m.M)  # dropped when invalid
    obs_kf = m.mp_obs_kf.at[mp_w, slot].set(
        kf_ids.astype(jnp.int32), mode="drop"
    )
    obs_kp = m.mp_obs_kp.at[mp_w, slot].set(
        kp_idx.astype(jnp.int32), mode="drop"
    )
    oct_new = m.kf_octave[
        jnp.clip(kf_ids, 0, m.K - 1), jnp.clip(kp_idx, 0, m.N - 1)
    ]
    obs_oct = m.mp_obs_oct.at[mp_w, slot].set(
        oct_new.astype(jnp.int32), mode="drop"
    )
    st_new = m.kf_right_u[
        jnp.clip(kf_ids, 0, m.K - 1), jnp.clip(kp_idx, 0, m.N - 1)
    ] >= 0
    obs_st = m.mp_obs_stereo.at[mp_w, slot].set(st_new, mode="drop")
    return (
        m._replace(
            mp_obs_kf=obs_kf, mp_obs_kp=obs_kp, mp_obs_oct=obs_oct,
            mp_obs_stereo=obs_st,
        ),
        okw,
    )


def erase_observations(m: MapState, mp_ids: jax.Array, kf_ids: jax.Array) -> MapState:
    """Remove observation (kf, *) from each point in mp_ids (batched).

    MapPoint::eraseObservation + Frame slot clear (mapPoint.cpp:58-127).
    """
    mp = jnp.clip(mp_ids, 0, m.M - 1)
    ok = (mp_ids >= 0)[:, None]
    hit = (m.mp_obs_kf[mp] == kf_ids[:, None]) & ok  # (B,O)
    kp_slots = m.mp_obs_kp[mp]
    obs_kf = m.mp_obs_kf.at[mp[:, None], jnp.arange(m.O)[None, :]].set(
        jnp.where(hit, -1, m.mp_obs_kf[mp]), mode="drop"
    )
    obs_kp = m.mp_obs_kp.at[mp[:, None], jnp.arange(m.O)[None, :]].set(
        jnp.where(hit, -1, kp_slots), mode="drop"
    )
    # Clear the keyframe keypoint slot as well.
    kf_w = jnp.where(mp_ids >= 0, kf_ids, 0)
    kp_any = jnp.where(hit, kp_slots, -1).max(axis=-1)
    kf_mp = m.kf_mp.at[kf_w, jnp.clip(kp_any, 0, m.N - 1)].set(
        jnp.where((kp_any >= 0) & (mp_ids >= 0), -1, m.kf_mp[kf_w, jnp.clip(kp_any, 0, m.N - 1)]),
        mode="drop",
    )
    return m._replace(mp_obs_kf=obs_kf, mp_obs_kp=obs_kp, kf_mp=kf_mp)


def recount_obs(m: MapState) -> jax.Array:
    """(M,) number of live observations per point."""
    return jnp.sum(m.mp_obs_kf >= 0, axis=-1)


def recount_obs_weighted(m: MapState) -> jax.Array:
    """(M,) reference observationsNum: stereo/RGB-D observations count
    DOUBLE (mapPoint.cpp:96-99).  This is the number the recent-point
    cull (localMapping.cpp:102) and trackedMapPointsNum gates
    (keyFrame.cpp:221) compare against."""
    live = m.mp_obs_kf >= 0
    return jnp.sum(
        jnp.where(live, 1 + m.mp_obs_stereo.astype(jnp.int32), 0), axis=-1
    )


# ----------------------------------------------------------------------
# Derived point attributes
# ----------------------------------------------------------------------

def refresh_points(
    m: MapState, mp_ids: jax.Array, scale_factor: float, n_levels: int
) -> MapState:
    """Recompute distinctive descriptor + normal + scale band for a batch
    of points (fixed batch size with -1 padding).

    MapPoint::computeDistinctiveDescriptors (min-median-Hamming over all
    observation descriptors, src/mapPoint.cpp:169-218) and
    updateNormalAndDepth (mean viewing ray; band from the reference
    keyframe's octave, src/mapPoint.cpp:219-250).
    """
    B = mp_ids.shape[0]
    mp = jnp.clip(mp_ids, 0, m.M - 1)
    ok = (mp_ids >= 0) & m.mp_valid[mp]
    obs_kf = m.mp_obs_kf[mp]  # (B,O)
    obs_kp = m.mp_obs_kp[mp]
    has = obs_kf >= 0
    kfc = jnp.clip(obs_kf, 0, m.K - 1)
    kpc = jnp.clip(obs_kp, 0, m.N - 1)
    descs = m.kf_desc[kfc, kpc]  # (B,O,8)

    # Min-median-distance descriptor.
    d = jax.vmap(distance_matrix)(descs, descs)  # (B,O,O)
    big = 10_000
    d = jnp.where(has[:, None, :] & has[:, :, None], d, big)
    d_sorted = jnp.sort(d, axis=-1)  # per row
    n_obs = jnp.sum(has, axis=-1)  # (B,)
    med_idx = jnp.clip(n_obs // 2, 0, m.O - 1)
    median = jnp.take_along_axis(
        d_sorted, med_idx[:, None, None].repeat(m.O, axis=1), axis=-1
    )[..., 0]  # (B,O)
    median = jnp.where(has, median, big)
    best = jnp.argmin(median, axis=-1)  # (B,)
    new_desc = jnp.take_along_axis(descs, best[:, None, None].repeat(8, -1), axis=1)[
        :, 0
    ]

    # Normal: mean unit vector from observing camera centers to the point.
    # Camera centers come from ONE (K,3) table computed on the dense
    # (K,4,4) pose array — a (B,O,3) gather instead of a (B,O,4,4)
    # gather + per-obs einsum (gathers are the cost here: 16 -> 3 words
    # per observation; measured ~2x faster refresh at B=1024, O=32).
    centers_all = -jnp.einsum(
        "kij,kj->ki", jnp.swapaxes(m.kf_pose[..., :3, :3], -1, -2),
        m.kf_pose[..., :3, 3],
    )  # (K,3)
    centers = centers_all[kfc]  # (B,O,3)
    pos = m.mp_pos[mp][:, None, :]
    rays = pos - centers
    ray_norm = jnp.linalg.norm(rays, axis=-1, keepdims=True)
    unit = jnp.where(has[..., None], rays / jnp.maximum(ray_norm, 1e-6), 0.0)
    normal = jnp.sum(unit, axis=1) / jnp.maximum(n_obs[:, None], 1)

    # Scale band from the reference keyframe observation (use the first
    # live obs as reference — the reference uses m_refKeyFrame).
    first = jnp.argmax(has, axis=-1)
    ref_kf = jnp.take_along_axis(kfc, first[:, None], axis=-1)[:, 0]
    ref_kp = jnp.take_along_axis(kpc, first[:, None], axis=-1)[:, 0]
    ref_center = centers_all[ref_kf]
    dist_ref = jnp.linalg.norm(m.mp_pos[mp] - ref_center, axis=-1)
    octv = m.kf_octave[ref_kf, ref_kp]
    level_scale = scale_factor ** octv.astype(jnp.float32)
    max_dist = dist_ref * level_scale
    min_dist = max_dist / (scale_factor ** (n_levels - 1))

    okb = ok & (n_obs > 0)
    mp_w = jnp.where(okb, mp, m.M - 1)

    def put(arr, new):
        cur = arr[mp_w]
        return arr.at[mp_w].set(jnp.where(okb.reshape((B,) + (1,) * (new.ndim - 1)), new, cur), mode="drop")

    return m._replace(
        mp_desc=put(m.mp_desc, new_desc),
        mp_normal=put(m.mp_normal, normal),
        mp_max_dist=put(m.mp_max_dist, max_dist),
        mp_min_dist=put(m.mp_min_dist, min_dist),
        mp_ref_kf=put(m.mp_ref_kf, ref_kf.astype(jnp.int32)),
    )


def replace_points(
    m: MapState,
    old_ids: jax.Array,
    new_ids: jax.Array,
    ok: jax.Array,
    scale_factor: float,
    n_levels: int,
) -> MapState:
    """Batched ``MapPoint::beReplacedBy`` (src/mapPoint.cpp:128-157):
    each surviving point ``new`` absorbs the observations of its dying
    ``old`` — every keyframe slot bound to ``old`` rebinds to ``new``
    (unless ``new`` is already observed there, in which case the slot is
    erased), found/visible counters fold in, ``old`` is invalidated, and
    the survivors' distinctive descriptor / normal / scale band refresh.

    This is the primitive behind loop-closure point binding and
    whole-group ``searchAndFuse`` (loopClosing.cpp:295-352) — the
    mechanism that creates CROSS-LOOP covisibility links: after
    replacement the survivor is co-observed by keyframes on both sides
    of the loop, which is exactly what the essential graph's
    loopConnections edge set reads off (loopClosing.cpp:311-325).

    Batch rules replacing the reference's sequential calls: duplicate
    ``old`` entries keep the first row; rows whose ``old`` appears as a
    ``new`` elsewhere (or vice versa) are dropped — replacement chains
    must go through a second call.
    """
    R = old_ids.shape[0]
    oldc = jnp.clip(old_ids, 0, m.M - 1)
    newc = jnp.clip(new_ids, 0, m.M - 1)
    ok = (
        ok & (old_ids >= 0) & (new_ids >= 0) & (old_ids != new_ids)
        & m.mp_valid[oldc] & m.mp_valid[newc]
    )
    # First occurrence wins for a repeated old id.
    rows = jnp.arange(R, dtype=jnp.int32)
    first = jnp.full((m.M + 1,), R, jnp.int32).at[
        jnp.where(ok, oldc, m.M)
    ].min(rows, mode="drop")
    ok &= first[oldc] == rows
    # Chain guard (conservative: tested against the whole batch).
    used_new = jnp.zeros((m.M,), bool).at[
        jnp.where(ok, newc, m.M)
    ].set(True, mode="drop")
    used_old = jnp.zeros((m.M,), bool).at[
        jnp.where(ok, oldc, m.M)
    ].set(True, mode="drop")
    ok &= ~used_new[oldc] & ~used_old[newc]

    # Observation transfer: each live obs (kf, kp) of old moves to new
    # unless new is already observed in that keyframe.
    okf = m.mp_obs_kf[oldc]  # (R,O)
    okp = m.mp_obs_kp[oldc]
    live = (okf >= 0) & ok[:, None]
    in_new = jnp.any(
        okf[:, :, None] == m.mp_obs_kf[newc][:, None, :], axis=-1
    )  # (R,O)
    transfer = live & ~in_new
    m, okw = add_observations_multi(
        m,
        jnp.where(transfer, newc[:, None], -1).reshape(-1),
        okf.reshape(-1),
        okp.reshape(-1),
        transfer.reshape(-1),
    )
    okw = okw.reshape(R, m.O)
    # Rebind the keyframe slots: new where the transfer landed an obs
    # slot, erased otherwise (new already there, or new at obs capacity
    # — the dying old cannot keep the binding either way).
    tgt = jnp.where(transfer & okw, newc[:, None], -1)
    kf_w = jnp.where(live, okf, m.K)  # out-of-range rows drop
    kf_mp = m.kf_mp.at[
        kf_w.reshape(-1), jnp.clip(okp, 0, m.N - 1).reshape(-1)
    ].set(tgt.reshape(-1), mode="drop")

    # Fold counters, invalidate old, clear its obs rows.
    new_w = jnp.where(ok, newc, m.M)
    mp_found = m.mp_found.at[new_w].add(
        jnp.where(ok, m.mp_found[oldc], 0), mode="drop"
    )
    mp_visible = m.mp_visible.at[new_w].add(
        jnp.where(ok, m.mp_visible[oldc], 0), mode="drop"
    )
    old_w = jnp.where(ok, oldc, m.M)
    m = m._replace(
        kf_mp=kf_mp,
        mp_found=mp_found,
        mp_visible=mp_visible,
        mp_valid=m.mp_valid.at[old_w].set(False, mode="drop"),
        mp_obs_kf=m.mp_obs_kf.at[old_w, :].set(-1, mode="drop"),
        mp_obs_kp=m.mp_obs_kp.at[old_w, :].set(-1, mode="drop"),
    )
    # Survivors' descriptor/normal/band see the absorbed observations
    # (computeDistinctiveDescriptors + updateNormalAndDepth in the
    # reference's beReplacedBy).
    return refresh_points(
        m, jnp.where(ok, new_ids, -1), scale_factor, n_levels
    )


def recompute_covis_all(m: MapState) -> MapState:
    """Rebuild the WHOLE covisibility matrix from the observation lists.

    The loop-closure fuse stage rewires observations across arbitrary
    keyframes (replace_points), so the incremental one-row
    ``update_covisibility`` no longer covers the change set — the
    reference walks updateConnections() over every corrected-group
    keyframe (loopClosing.cpp:311-317); observer sets of NON-group
    keyframes change too (loop-side points absorb current-side obs).

    weight(i, j) = #shared points = (A^T A)[i, j] with A the (M, K)
    point-observer incidence — one matmul per M-block instead of
    K gather-heavy row updates.  Spanning tree and parents untouched.
    """
    K, M, O = m.K, m.M, m.O
    B = min(M, 4096)
    nb = -(-M // B)
    pad = nb * B - M
    obs = jnp.pad(m.mp_obs_kf, ((0, pad), (0, 0)), constant_values=-1)
    val = jnp.pad(m.mp_valid, (0, pad))
    obs = obs.reshape(nb, B, O)
    val = val.reshape(nb, B)

    def step(acc, inp):
        o, v = inp
        onehot = jnp.any(
            (o[..., None] == jnp.arange(K, dtype=jnp.int32)) & (o[..., None] >= 0),
            axis=1,
        )  # (B,K)
        a = (onehot & v[:, None]).astype(jnp.float32)
        return acc + a.T @ a, None

    covis, _ = jax.lax.scan(step, jnp.zeros((K, K), jnp.float32), (obs, val))
    covis = covis.astype(jnp.int32)
    covis = covis * (1 - jnp.eye(K, dtype=jnp.int32))
    covis = jnp.where(
        m.kf_valid[:, None] & m.kf_valid[None, :], covis, 0
    )
    return m._replace(covis=covis)


# ----------------------------------------------------------------------
# Covisibility + spanning tree
# ----------------------------------------------------------------------

def update_covisibility(m: MapState, kf_id) -> MapState:
    """Recompute the covisibility row/col of one keyframe.

    KeyFrame::updateConnections (src/keyFrame.cpp:37-96): weight(i,j) =
    number of shared map points; edges kept if weight > 15 or the single
    max edge (we store ALL weights and let queries threshold — cheaper
    than pruning and strictly more information).  The spanning-tree
    parent of a new keyframe is its strongest earlier neighbor.
    """
    ids = m.kf_mp[kf_id]  # (N,)
    # Weights are counted from the points' OBSERVATION lists, exactly as
    # the reference iterates observation dicts (keyFrame.cpp:42-54): for
    # every point bound to this keyframe, each live observation votes
    # for its keyframe.  A dense (N, O, K) compare-reduce replaces a
    # (K, N)-sized gather from the (M,) membership table: elementwise
    # work that fuses, instead of a large gather.
    # (Obs lists cap at O slots; points observed by >O keyframes
    # undercount — the same points saturate any local window anyway.)
    idc = jnp.clip(ids, 0, m.M - 1)
    rows = m.mp_obs_kf[idc]  # (N,O) row gather
    live = (ids >= 0)[:, None] & (rows >= 0)
    votes = live[..., None] & (
        rows[..., None] == jnp.arange(m.K, dtype=jnp.int32)[None, None, :]
    )
    w = jnp.sum(votes, axis=(0, 1)).astype(jnp.int32)  # (K,)
    w = jnp.where(m.kf_valid, w, 0)
    w = w.at[kf_id].set(0)
    covis = m.covis.at[kf_id, :].set(w).at[:, kf_id].set(w)
    # Spanning tree: first connection -> parent = argmax weight among
    # earlier keyframes (keyFrame.cpp:90-94).  If no earlier keyframe
    # shares points yet (bootstrap), fall back to the most recent
    # earlier keyframe so every non-root node has a parent — the
    # trajectory writer's tree walk (system.cpp:209-223) needs a
    # connected tree.
    earlier = m.kf_valid & (m.kf_frame_id >= 0) & (
        m.kf_frame_id < m.kf_frame_id[kf_id]
    )
    w_earlier = jnp.where(earlier, w, -1)
    best = jnp.argmax(w_earlier)
    recent = jnp.argmax(jnp.where(earlier, m.kf_frame_id, -1))
    has_earlier = jnp.any(earlier)
    fallback = jnp.where(has_earlier, recent, -1)
    chosen = jnp.where(w_earlier[best] > 0, best, fallback)
    parent = jnp.where(
        m.parent[kf_id] < 0, chosen, m.parent[kf_id]
    ).astype(jnp.int32)
    return m._replace(covis=covis, parent=m.parent.at[kf_id].set(parent))


# ----------------------------------------------------------------------
# Keyframe insertion
# ----------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("scale_factor", "n_levels", "min_close_seed"),
    donate_argnums=(0,),
)
def insert_keyframe(
    m: MapState,
    kf_id,
    frame_id,
    timestamp,
    feats: FrameFeatures,
    T_cw: jax.Array,
    matched_mp: jax.Array,
    cam: CameraIntrinsics,
    depth_threshold: jax.Array,
    kf_count,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    min_close_seed: int = 100,
) -> Tuple[MapState, jax.Array]:
    """Insert a frame as keyframe ``kf_id`` (a free slot chosen by host).

    Mirrors Tracking::createNewKeyFrame + LocalMapping::processNewKeyFrame
    (src/tracking.cpp:797-844, src/localMapping.cpp:63-89):
      * store the frame arrays in the keyframe slot,
      * bind existing map-point matches and add observations,
      * seed NEW close points (depth in (0, depth_threshold]) for
        keypoints without a match (the reference sorts by depth and takes
        at least 100; we take all close ones — capacity-bounded),
      * refresh touched points, update covisibility + spanning tree.

    Returns (map, n_new_points).
    """
    N = m.N
    idx = jnp.arange(N)

    # 0. slot-reuse hygiene: clear every observation slot that still
    # references this keyframe id.  Culling clears the bound
    # observations it can see, but stale entries (e.g. a fusion loser's
    # old slot) may survive; once the slot is re-occupied they would be
    # attributed to the NEW keyframe, corrupting covisibility and scale
    # statistics.  This is a pure elementwise sweep over (M, O) — cheap.
    stale = m.mp_obs_kf == jnp.int32(kf_id)
    m = m._replace(
        mp_obs_kf=jnp.where(stale, -1, m.mp_obs_kf),
        mp_obs_kp=jnp.where(stale, -1, m.mp_obs_kp),
    )

    # 1. frame arrays into the keyframe slot
    matched_ok = (matched_mp >= 0) & feats.valid
    matched_ok &= m.mp_valid[jnp.clip(matched_mp, 0, m.M - 1)]
    # A keypoint with a RAW valid match must never seed a new point even
    # if the binding is rejected below by capacity/dedup gates — a
    # rejected binding would otherwise spawn a duplicate landmark
    # co-located with the existing one (the reference's matched
    # keypoints never reach the close-point seeding loop,
    # src/tracking.cpp:810-820).
    had_match = matched_ok
    # Binding requires a free obs slot (see obs_has_free).
    matched_ok &= obs_has_free(m, matched_mp)
    # One binding per point: if two keypoints matched the same map point
    # keep the lowest keypoint index (a duplicate binding would have no
    # obs entry, breaking the obs<->binding invariant that map-point
    # culling relies on).
    mclip = jnp.clip(matched_mp, 0, m.M - 1)
    first_kp = jnp.full((m.M + 1,), N, jnp.int32).at[
        jnp.where(matched_ok, mclip, m.M)
    ].min(idx.astype(jnp.int32), mode="drop")
    matched_ok &= first_kp[mclip] == idx

    # 2. new close points for unmatched keypoints with depth.  The
    # reference sorts candidates by depth and seeds at least
    # ``min_close_seed`` points even beyond ThDepth when too few are
    # close (tracking.cpp:804-837): the nearest min_close_seed
    # valid-depth unmatched keypoints always qualify.
    has_depth = feats.valid & (feats.depth > 0) & ~had_match
    close = has_depth & (feats.depth <= depth_threshold)
    depth_rank = jnp.argsort(
        jnp.argsort(jnp.where(has_depth, feats.depth, jnp.inf))
    )
    near_enough = has_depth & (depth_rank < min_close_seed)
    want_new = close | near_enough
    ranks = jnp.where(want_new, jnp.cumsum(want_new) - 1, -1)
    new_slots = alloc_slots(m.mp_valid, ranks)  # (N,) mp slot or -1
    created = new_slots >= 0

    p_c = backproject(cam, feats.uv, jnp.maximum(feats.depth, 1e-3))
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    p_w = (p_c - t) @ R

    slot_w = jnp.where(created, new_slots, m.M - 1)
    mp_pos = m.mp_pos.at[slot_w].set(
        jnp.where(created[:, None], p_w, m.mp_pos[slot_w]), mode="drop"
    )
    mp_valid = m.mp_valid.at[slot_w].set(
        jnp.where(created, True, m.mp_valid[slot_w]), mode="drop"
    )
    # mp_first_kf stores the KEYFRAME COUNT at creation (not the slot id)
    # so the recent-point age rule survives slot reuse.
    mp_first = m.mp_first_kf.at[slot_w].set(
        jnp.where(created, jnp.int32(kf_count), m.mp_first_kf[slot_w]), mode="drop"
    )
    zero32 = jnp.zeros_like(m.mp_found[slot_w])
    m = m._replace(
        mp_pos=mp_pos,
        mp_valid=mp_valid,
        mp_first_kf=mp_first,
        mp_found=m.mp_found.at[slot_w].set(jnp.where(created, 1, m.mp_found[slot_w]), mode="drop"),
        mp_visible=m.mp_visible.at[slot_w].set(jnp.where(created, 1, m.mp_visible[slot_w]), mode="drop"),
        # fresh points start with empty obs lists
        mp_obs_kf=m.mp_obs_kf.at[slot_w].set(
            jnp.where(created[:, None], -1, m.mp_obs_kf[slot_w]), mode="drop"
        ),
        mp_obs_kp=m.mp_obs_kp.at[slot_w].set(
            jnp.where(created[:, None], -1, m.mp_obs_kp[slot_w]), mode="drop"
        ),
    )

    kf_mp_row = jnp.where(matched_ok, matched_mp, jnp.where(created, new_slots, -1))
    m = m._replace(
        kf_pose=m.kf_pose.at[kf_id].set(T_cw),
        kf_valid=m.kf_valid.at[kf_id].set(True),
        kf_timestamp=m.kf_timestamp.at[kf_id].set(timestamp),
        kf_frame_id=m.kf_frame_id.at[kf_id].set(jnp.int32(frame_id)),
        kf_uv=m.kf_uv.at[kf_id].set(feats.uv),
        kf_right_u=m.kf_right_u.at[kf_id].set(feats.right_u),
        kf_depth=m.kf_depth.at[kf_id].set(feats.depth),
        kf_octave=m.kf_octave.at[kf_id].set(feats.octave),
        kf_angle=m.kf_angle.at[kf_id].set(feats.angle),
        kf_desc=m.kf_desc.at[kf_id].set(feats.desc),
        kf_kp_valid=m.kf_kp_valid.at[kf_id].set(feats.valid),
        kf_mp=m.kf_mp.at[kf_id].set(kf_mp_row),
    )

    # 3. observations for both matched and created points
    m = add_observations(m, kf_mp_row, kf_id, idx, kf_mp_row >= 0)

    # 4. refresh all touched points (descriptor/normal/band)
    m = refresh_points(m, jnp.where(kf_mp_row >= 0, kf_mp_row, -1),
                       scale_factor, n_levels)

    # 5. graph updates
    m = update_covisibility(m, kf_id)
    return m, jnp.sum(created)
