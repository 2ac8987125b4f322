"""New-point triangulation and neighbor fusion for local mapping.

Replaces ``LocalMapping::createNewMapPoints`` (src/localMapping.cpp:
109-252: epipolar-guided matching against covisible neighbors, SVD
triangulation, parallax/positive-depth/reprojection/scale checks) and
``searchInNeighbors`` + ``OrbMatcher::fuseByProjection``
(src/localMapping.cpp:253-294, src/orbMatcher.cpp:682-745).

Shape: per neighbor pair the epipolar search is one gated best/second
Hamming search (ops/best2.py) whose gate is the point-to-epipolar-line
distance test; triangulation is a closed-form solve vmapped over all
candidate pairs at once.  All covisible neighbors are searched as one
batch (top-k covisible).

Fusion: when a projected map point lands on a keypoint that already
holds a different point, the two are duplicates of one landmark and
merge as in the reference (MapPoint::beReplacedBy,
src/mapPoint.cpp:128-156): the point with fewer observations dies and
the other absorbs its whole observation list.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import inv_T
from ..ops.best2 import best2
from ..ops.hamming import INVALID_DIST
from .map_state import MapState, alloc_slots, refresh_points

# Per-pass row budget for duplicate-merge compaction in the fuse stage
# (see fuse_neighbors_batch): replace_points' cost scales with rows, so
# the sparse merge set is compacted to this many before the call.
FUSE_MERGE_BUDGET = 512
from .matchers import predict_scale_level, project_sources

N_TRIANG_NEIGHBORS = 10  # stereo neighbor count (localMapping.cpp:114)
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _camera_center(T_cw):
    return -T_cw[:3, :3].T @ T_cw[:3, 3]


def _fundamental_matrix(cam: CameraIntrinsics, T1_cw, T2_cw):
    """F21 such that x2^T F21 x1 = 0 (pixels), from relative pose 1->2.

    LocalMapping::computeFundamentalMatrix_first2second
    (localMapping.cpp:295-306).
    """
    T21 = T2_cw @ inv_T(T1_cw)
    R, t = T21[:3, :3], T21[:3, 3]
    tx = jnp.array(
        [[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]]
    )
    K = jnp.array(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]]
    )
    Kinv = jnp.linalg.inv(K)
    return Kinv.T @ tx @ R @ Kinv


def _triangulate_pairs(cam, T1, T2, uv1, uv2):
    """Linear two-view triangulation, closed form.

    The reference solves the homogeneous 4x4 DLT system by SVD
    (localMapping.cpp:176-199); batched tiny SVDs are iterative, so we
    solve the equivalent INHOMOGENEOUS least squares
    A[:, :3] X = -A[:, 3] via 3x3 normal equations (documented
    deviation: identical up to the w=1 normalization, and every
    candidate still passes the reprojection chi2 gates below).
    """
    K = jnp.array(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]]
    )
    P1 = K @ T1[:3, :4]
    P2 = K @ T2[:3, :4]

    def one(u1, u2):
        A = jnp.stack(
            [
                u1[0] * P1[2] - P1[0],
                u1[1] * P1[2] - P1[1],
                u2[0] * P2[2] - P2[0],
                u2[1] * P2[2] - P2[1],
            ]
        )  # (4,4)
        A3 = A[:, :3]
        b = -A[:, 3]
        G = A3.T @ A3
        rhs = A3.T @ b
        from ..optim.schur import inv3x3

        return inv3x3(G + 1e-9 * jnp.eye(3)) @ rhs

    return jax.vmap(one)(uv1, uv2)


def _tri_pair_setup(
    m: MapState, kf1, kf2, cam: CameraIntrinsics, n_levels: int,
    scale_factor: float,
):
    """Per-pair epipolar-gate inputs of the triangulation search:
    epipolar lines of kf1's
    keypoints in kf2's image, squared-threshold row scale, and the
    free-keypoint masks (localMapping.cpp:128)."""
    sf = scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)
    sigma2 = sf * sf
    T1, T2 = m.kf_pose[kf1], m.kf_pose[kf2]
    free1 = m.kf_kp_valid[kf1] & (m.kf_mp[kf1] < 0)
    free2 = m.kf_kp_valid[kf2] & (m.kf_mp[kf2] < 0)
    uv1, uv2 = m.kf_uv[kf1], m.kf_uv[kf2]
    F21 = _fundamental_matrix(cam, T1, T2)
    x1h = jnp.concatenate([uv1, jnp.ones((m.N, 1))], -1)  # (N,3)
    lines = x1h @ F21.T  # (N,3) epipolar lines in image 2
    # Compare num^2 < 3.84 sigma^2 den^2 instead of dividing: saves a
    # (N,N) divide+sqrt on the VPU (orbMatcher.cpp:808-819 math).
    den2 = lines[:, 0] ** 2 + lines[:, 1] ** 2
    thr = 3.84 * jnp.maximum(den2, 1e-18)
    return dict(
        sigma2=sigma2, free1=free1, free2=free2, uv2=uv2, lines=lines,
        thr=thr,
    )


def _tri_select(b1, b2, idx, ratio: float, N: int):
    """Shared post-search selection: TH_LOW + best/second ratio + the
    kf2-side collision resolve, from per-row (best, second, argbest).

    If two kf1 keypoints claim the same kf2 keypoint, keep only the
    closer pair — otherwise the loser's new point gets an observation of
    (kf2, kp) that kf_mp never mirrors, breaking the obs<->binding
    invariant.  Ties go to the lower kf1 row (matches the dense argmin).
    """
    # Best/second ratio (the matcher constructed at localMapping.cpp:112);
    # second-best clamps to 256 — the reference's bestDist2 init — so
    # lone candidates face the same gate.  TH_LOW=50 (orbMatcher.cpp:8).
    b2c = jnp.minimum(b2, 256)
    matched = (
        (idx >= 0)
        & (b1 <= 50)
        & (b1.astype(jnp.float32) < ratio * b2c.astype(jnp.float32))
    )
    rows = jnp.arange(N, dtype=jnp.int32)
    big = jnp.int32(INVALID_DIST * 16384)
    key = jnp.where(matched, b1 * N + rows, big)
    col = jnp.where(matched, idx, N)
    colmin = jnp.full((N,), big, jnp.int32).at[col].min(key, mode="drop")
    matched &= colmin[jnp.clip(idx, 0, N - 1)] == key
    return matched, jnp.clip(idx, 0, N - 1)


def _tri_geom(
    m: MapState, kf1, kf2, active, matched, best2,
    cam: CameraIntrinsics, scale_factor: float, n_levels: int,
):
    """Triangulation + acceptance checks for selected pairs (shared by
    both search paths): parallax decision, stereo fallbacks, two-view
    chi2/scale gates (localMapping.cpp:176-244)."""
    sf = scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)
    sigma2 = sf * sf
    T1, T2 = m.kf_pose[kf1], m.kf_pose[kf2]
    c1, c2 = _camera_center(T1), _camera_center(T2)
    baseline = jnp.linalg.norm(c1 - c2)
    uv1, uv2 = m.kf_uv[kf1], m.kf_uv[kf2]
    uv2m = uv2[best2]
    X_tri = _triangulate_pairs(cam, T1, T2, uv1, uv2m)

    # Parallax decision (localMapping.cpp:176-199): triangulate only when
    # the ray parallax beats the stereo parallax of either view;
    # otherwise back-project the stereo depth (low-parallax pairs
    # triangulate arbitrarily bad depths that still reproject well).
    R1w, t1 = T1[:3, :3], T1[:3, 3]
    R2w, t2 = T2[:3, :3], T2[:3, 3]
    ray1 = (
        jnp.stack(
            [(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy,
             jnp.ones((m.N,))], -1,
        )
        @ R1w
    )
    ray2 = (
        jnp.stack(
            [(uv2m[:, 0] - cam.cx) / cam.fx, (uv2m[:, 1] - cam.cy) / cam.fy,
             jnp.ones((m.N,))], -1,
        )
        @ R2w
    )
    cos_rays = jnp.sum(ray1 * ray2, -1) / jnp.maximum(
        jnp.linalg.norm(ray1, -1) * jnp.linalg.norm(ray2, -1), 1e-9
    )
    d1s = m.kf_depth[kf1]
    d2s = m.kf_depth[kf2][best2]
    b_half = 0.5 * cam.bf / cam.fx
    cos_st1 = jnp.cos(2.0 * jnp.arctan2(b_half, jnp.maximum(d1s, 1e-3)))
    cos_st2 = jnp.cos(2.0 * jnp.arctan2(b_half, jnp.maximum(d2s, 1e-3)))
    cos_st1 = jnp.where(d1s > 0, cos_st1, 2.0)  # no stereo -> never wins
    cos_st2 = jnp.where(d2s > 0, cos_st2, 2.0)
    cos_stereo = jnp.minimum(cos_st1, cos_st2)
    good_parallax = (cos_rays > 0) & (cos_rays < 0.9998) & (
        cos_rays < cos_stereo
    )
    # Stereo fallbacks: inverseProject of whichever view has depth.
    c1w = -R1w.T @ t1
    X_st1 = (
        jnp.stack(
            [(uv1[:, 0] - cam.cx) / cam.fx * d1s,
             (uv1[:, 1] - cam.cy) / cam.fy * d1s, d1s], -1,
        )
        - t1
    ) @ R1w
    X_st2 = (
        jnp.stack(
            [(uv2m[:, 0] - cam.cx) / cam.fx * d2s,
             (uv2m[:, 1] - cam.cy) / cam.fy * d2s, d2s], -1,
        )
        - t2
    ) @ R2w
    use_st1 = ~good_parallax & (d1s > 0)
    use_st2 = ~good_parallax & ~use_st1 & (d2s > 0)
    X = jnp.where(
        good_parallax[:, None], X_tri,
        jnp.where(use_st1[:, None], X_st1, X_st2),
    )
    has_source = good_parallax | use_st1 | use_st2

    # Checks (localMapping.cpp:200-244): positive depth both views,
    # reprojection chi2 both views (stereo keypoints get the 3-term
    # (u, v, ur) residual against the reference's literal 7.8 factor,
    # localMapping.cpp:210,218), scale consistency.
    def checks(X):
        pc1 = T1[:3, :3] @ X.T + T1[:3, 3:4]
        pc2 = T2[:3, :3] @ X.T + T2[:3, 3:4]
        z1, z2 = pc1[2], pc2[2]
        z1s, z2s = jnp.maximum(z1, 1e-6), jnp.maximum(z2, 1e-6)
        u1p = cam.fx * pc1[0] / z1s + cam.cx
        v1p = cam.fy * pc1[1] / z1s + cam.cy
        u2p = cam.fx * pc2[0] / z2s + cam.cx
        v2p = cam.fy * pc2[1] / z2s + cam.cy
        e1 = (u1p - uv1[:, 0]) ** 2 + (v1p - uv1[:, 1]) ** 2
        e2 = (u2p - uv2m[:, 0]) ** 2 + (v2p - uv2m[:, 1]) ** 2
        ok = (z1 > 0) & (z2 > 0)
        # Stereo keypoints: add the right-x residual (predicted
        # ur = u - bf/z vs the measured right-x) and widen to 7.8.
        r1 = m.kf_right_u[kf1]
        r2 = m.kf_right_u[kf2][best2]
        e1r = e1 + (u1p - cam.bf / z1s - r1) ** 2
        e2r = e2 + (u2p - cam.bf / z2s - r2) ** 2
        s2_1 = sigma2[m.kf_octave[kf1]]
        s2_2 = sigma2[m.kf_octave[kf2][best2]]
        ok &= jnp.where(r1 >= 0, e1r <= 7.8 * s2_1, e1 <= CHI2_MONO * s2_1)
        ok &= jnp.where(r2 >= 0, e2r <= 7.8 * s2_2, e2 <= CHI2_MONO * s2_2)
        # Scale consistency (localMapping.cpp:231-238): ratioDist =
        # dist_connected / dist_current vs ratioOctave = sf1 / sf2, band
        # factor 1.5 * scaleFactor.  (Earlier rounds compared the
        # INVERTED distance ratio to the same octave ratio — a band
        # centered on the wrong side whenever octaves differ.)
        d1 = jnp.linalg.norm(X - c1[None], axis=-1)
        d2 = jnp.linalg.norm(X - c2[None], axis=-1)
        ratio_d = d2 / jnp.maximum(d1, 1e-6)
        ratio_o = sf[m.kf_octave[kf1]] / sf[m.kf_octave[kf2][best2]]
        factor = 1.5 * scale_factor
        ok &= (d1 > 1e-6) & (d2 > 1e-6)
        ok &= (ratio_d * factor >= ratio_o) & (ratio_d <= ratio_o * factor)
        return ok

    good = (
        matched & has_source & checks(X) & (baseline > cam.bf / cam.fx) & active
    )
    return good, best2, X


def _tri_attrs(
    m: MapState, kf1, kf2, active, cam: CameraIntrinsics, n_levels: int,
    scale_factor: float,
):
    """Pack the epipolar gates as ops.best2 "epi" attribute lanes
    (per-pair O(N) vectors; the (N, N) comparisons happen in the
    search)."""
    s = _tri_pair_setup(m, kf1, kf2, cam, n_levels, scale_factor)
    f = jnp.float32
    z = jnp.zeros((m.N,), f)
    lines = s["lines"]
    a_attr = jnp.stack(
        [
            lines[:, 0].astype(f), lines[:, 1].astype(f),
            lines[:, 2].astype(f), s["thr"].astype(f),
            m.kf_octave[kf1].astype(f),
            (s["free1"] & active).astype(f), z, z,
        ],
        -1,
    )
    oct2 = m.kf_octave[kf2]
    b_attr = jnp.stack(
        [
            s["uv2"][:, 0].astype(f), s["uv2"][:, 1].astype(f),
            s["sigma2"][oct2], oct2.astype(f), s["free2"].astype(f),
            z, z, z,
        ],
        -1,
    )
    return a_attr, b_attr


def triangulate_neighbors_batch(
    m: MapState,
    kf1,
    nids: jax.Array,  # (B,) neighbor keyframe ids (-1 padded)
    nok: jax.Array,  # (B,) bool
    kf_count,
    cam: CameraIntrinsics,
    scale_factor: float,
    n_levels: int,
    ratio: float = 0.6,
) -> MapState:
    """Triangulate kf1 against ALL covisible neighbors in one batch.

    The candidate search ((N, N) epipolar + Hamming per pair) vmaps over
    the neighbor axis; the map writes happen ONCE: each kf1 keypoint
    takes its first (covisibility-ordered) accepting neighbor, new
    points get both observations written directly into their (empty)
    obs rows.  Deviation from the sequential reference loop
    (localMapping.cpp:109-252): later neighbors see kf1 keypoints bound
    by earlier ones as still free during the SEARCH (binding is resolved
    afterwards), which can only drop a handful of matches, never corrupt
    state."""
    kf2c = jnp.clip(nids, 0, m.K - 1)
    B = nids.shape[0]
    a_attr, b_attr = jax.vmap(
        lambda k2, act: _tri_attrs(
            m, kf1, k2, act, cam, n_levels, scale_factor
        )
    )(kf2c, nok)  # (B,N,8) x2
    desc_a = jnp.broadcast_to(m.kf_desc[kf1][None], (B, m.N, 8))
    ((idx, b1, b2),) = best2(
        desc_a, a_attr, m.kf_desc[kf2c], b_attr, "epi"
    )  # (B,N) x3
    good, best2_kp, X = jax.vmap(
        lambda k2, act, i, d1, d2: _tri_geom(
            m, kf1, k2, act, *_tri_select(d1, d2, i, ratio, m.N),
            cam, scale_factor, n_levels,
        )
    )(kf2c, nok, idx, b1, b2)

    pick = jnp.argmax(good, axis=0)  # (N,) first accepting neighbor
    any_good = jnp.any(good, axis=0)
    sel_kf2 = kf2c[pick]
    sel_best2 = jnp.take_along_axis(best2_kp, pick[None, :], axis=0)[0]
    sel_X = jnp.take_along_axis(X, pick[None, :, None], axis=0)[0]

    ranks = jnp.where(any_good, jnp.cumsum(any_good) - 1, -1)
    slots = alloc_slots(m.mp_valid, ranks)
    created = slots >= 0
    slot_w = jnp.where(created, slots, m.M)  # M -> dropped
    idx = jnp.arange(m.N)
    oct1 = m.kf_octave[kf1]
    oct2 = m.kf_octave[sel_kf2, sel_best2]
    # Fresh points: write both observations straight into slots 0/1.
    obs_kf_rows = (
        jnp.full((m.N, m.O), -1, jnp.int32)
        .at[:, 0].set(jnp.int32(kf1) + jnp.zeros((m.N,), jnp.int32))
        .at[:, 1].set(sel_kf2)
    )
    obs_kp_rows = (
        jnp.full((m.N, m.O), -1, jnp.int32)
        .at[:, 0].set(idx.astype(jnp.int32))
        .at[:, 1].set(sel_best2)
    )
    obs_oct_rows = (
        jnp.zeros((m.N, m.O), jnp.int32).at[:, 0].set(oct1).at[:, 1].set(oct2)
    )
    obs_st_rows = (
        jnp.zeros((m.N, m.O), bool)
        .at[:, 0].set(m.kf_right_u[kf1] >= 0)
        .at[:, 1].set(m.kf_right_u[sel_kf2, sel_best2] >= 0)
    )
    m = m._replace(
        mp_pos=m.mp_pos.at[slot_w].set(sel_X, mode="drop"),
        mp_valid=m.mp_valid.at[slot_w].set(True, mode="drop"),
        mp_first_kf=m.mp_first_kf.at[slot_w].set(
            jnp.int32(0) + kf_count, mode="drop"
        ),
        mp_found=m.mp_found.at[slot_w].set(1, mode="drop"),
        mp_visible=m.mp_visible.at[slot_w].set(1, mode="drop"),
        mp_obs_kf=m.mp_obs_kf.at[slot_w].set(obs_kf_rows, mode="drop"),
        mp_obs_kp=m.mp_obs_kp.at[slot_w].set(obs_kp_rows, mode="drop"),
        mp_obs_oct=m.mp_obs_oct.at[slot_w].set(obs_oct_rows, mode="drop"),
        mp_obs_stereo=m.mp_obs_stereo.at[slot_w].set(
            obs_st_rows, mode="drop"
        ),
        kf_mp=m.kf_mp.at[kf1].set(jnp.where(created, slots, m.kf_mp[kf1]))
        .at[jnp.where(created, sel_kf2, m.K), sel_best2]
        .set(slots, mode="drop"),
    )
    return m


@functools.partial(
    jax.jit, static_argnames=("scale_factor", "n_levels"), donate_argnums=(0,)
)
def refresh_kf_points(
    m: MapState, kf_id, cam: CameraIntrinsics, scale_factor: float,
    n_levels: int,
) -> MapState:
    """Refresh descriptor/normal/band for every point bound to a keyframe
    (batched once instead of once per neighbor interaction)."""
    return refresh_points(
        m, jnp.where(m.kf_mp[kf_id] >= 0, m.kf_mp[kf_id], -1),
        scale_factor, n_levels,
    )


def _fuse_pair_setup(
    m: MapState, src_kf, dst_kf, cam: CameraIntrinsics,
    scale_factor: float, n_levels: int,
):
    """Per-pair fuse-by-projection gate inputs: src_kf's bound points
    projected into dst_kf, the scale-predicted search radius and octave range, and the composite
    source validity (frustum + distance band + not-already-observed)."""
    sf = scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)
    ids = m.kf_mp[src_kf]  # (N,)
    idc = jnp.clip(ids, 0, m.M - 1)
    pt_ok = (ids >= 0) & m.mp_valid[idc]
    pos = m.mp_pos[idc]
    T = m.kf_pose[dst_kf]
    proj = project_sources(cam, T, pos, pt_ok, border=5.0)
    center = _camera_center(T)
    po = pos - center[None]
    dist = jnp.linalg.norm(po, axis=-1)
    band_ok = (dist >= 0.8 * m.mp_min_dist[idc]) & (dist <= 1.2 * m.mp_max_dist[idc])
    # Viewing-direction gate (orbMatcher.cpp:708): the candidate must be
    # seen from within 60 degrees of its mean viewing ray.
    view_cos = jnp.sum(po * m.mp_normal[idc], axis=-1) / jnp.maximum(
        dist * jnp.linalg.norm(m.mp_normal[idc], axis=-1), 1e-6
    )
    pred = predict_scale_level(dist, 1.2 * m.mp_max_dist[idc], n_levels, scale_factor)
    radius = 3.0 * sf[pred]
    # Already-observed points must not rebind (reference skips points
    # already in the target keyframe).
    already = jnp.any(m.mp_obs_kf[idc] == dst_kf, axis=-1)
    valid_src = pt_ok & proj.valid & band_ok & (view_cos >= 0.5) & ~already
    return dict(
        ids=ids, idc=idc, uv=proj.uv, ur=proj.ur, radius=radius, pred=pred,
        valid_src=valid_src,
    )


def _fuse_select(idx, b1, active, ids, N: int):
    """Shared post-search resolution: TH_LOW gate (fuse uses TH_LOW,
    orbMatcher.cpp:737) then one source point per dst keypoint (min
    distance, ties to the lower src row).  Returns
    (bound (N,) bool, cand_mp (N,) i32, who_d (N,) i32) over dst
    keypoints."""
    hit = (idx >= 0) & (b1 <= 50)
    rows = jnp.arange(N, dtype=jnp.int32)
    big = jnp.int32(INVALID_DIST * 16384)
    key = jnp.where(hit, b1 * N + rows, big)
    col = jnp.where(hit, idx, N)
    colmin = jnp.full((N,), big, jnp.int32).at[col].min(key, mode="drop")
    bound = (colmin < big) & active
    who = jnp.where(bound, colmin % N, 0)
    who_d = jnp.where(bound, colmin // N, INVALID_DIST)
    return bound, ids[who], who_d


def _fuse_attrs(
    m: MapState, src_kf, dst_kf, cam: CameraIntrinsics,
    scale_factor: float, n_levels: int,
):
    """Pack the fuse gates as ops.best2 "fuse" attribute lanes."""
    s = _fuse_pair_setup(m, src_kf, dst_kf, cam, scale_factor, n_levels)
    f = jnp.float32
    z = jnp.zeros((m.N,), f)
    rad = s["radius"].astype(f)
    a_attr = jnp.stack(
        [
            s["uv"][:, 0].astype(f), s["uv"][:, 1].astype(f),
            s["ur"].astype(f),
            rad, rad,
            (s["pred"] - 1).astype(f), s["pred"].astype(f),
            s["valid_src"].astype(f),
        ],
        -1,
    )
    # Lane B_ISF2 carries 1/sf^2(octave), the fuse chi2 weight
    # (orbMatcher.cpp:714-721).
    sf = scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)
    isf2 = 1.0 / sf[jnp.clip(m.kf_octave[dst_kf], 0, n_levels - 1)] ** 2
    b_attr = jnp.stack(
        [
            m.kf_uv[dst_kf][:, 0].astype(f), m.kf_uv[dst_kf][:, 1].astype(f),
            m.kf_right_u[dst_kf].astype(f), m.kf_octave[dst_kf].astype(f),
            m.kf_kp_valid[dst_kf].astype(f), isf2, z, z,
        ],
        -1,
    )
    return a_attr, b_attr


def fuse_neighbors_batch(
    m: MapState,
    kf1,
    nids: jax.Array,  # (B,) neighbor ids (-1 padded)
    nok: jax.Array,  # (B,) bool
    cam: CameraIntrinsics,
    scale_factor: float,
    n_levels: int,
) -> MapState:
    """Two-way neighbor fusion in two batched passes.

    OUT pass: kf1's points project into every neighbor at once (vmap
    over dst); each neighbor's keypoint row merges independently.
    IN pass: every neighbor's points project into kf1 (vmap over src);
    the per-keypoint winner resolves ACROSS neighbors by Hamming
    distance, then one merge updates kf1's row.  Replaces the 2B
    sequential ``fuse_into_kf_body`` steps of searchInNeighbors
    (localMapping.cpp:253-294) — candidate order differs from the
    reference's sequential loop but the accept gates are identical.
    """
    from .map_state import (add_observations, add_observations_multi,
                            replace_points)

    B = nids.shape[0]
    kf2c = jnp.clip(nids, 0, m.K - 1)
    n_obs_tab = jnp.sum(m.mp_obs_kf >= 0, axis=-1)  # (M,)

    # ---------------- OUT: kf1 -> each neighbor ----------------
    ids1 = m.kf_mp[kf1]
    a_attr, b_attr = jax.vmap(
        lambda k2: _fuse_attrs(m, kf1, k2, cam, scale_factor, n_levels)
    )(kf2c)
    desc_a = jnp.broadcast_to(
        m.mp_desc[jnp.clip(ids1, 0, m.M - 1)][None], (B, m.N, 8)
    )
    ((idx_o, b1_o, _),) = best2(
        desc_a, a_attr, m.kf_desc[kf2c], b_attr, "fuse"
    )
    bound, cand, _ = jax.vmap(
        lambda i, d1, act: _fuse_select(i, d1, act, ids1, m.N)
    )(idx_o, b1_o, nok)
    existing = m.kf_mp[kf2c]  # (B,N)
    empty_slot = existing < 0
    bind = bound & empty_slot
    # Obs rows first: only entries that secured an obs slot may bind
    # (binding<->obs invariant; a point can gain several obs here).
    flat_pt = jnp.where(bind, cand, -1).reshape(-1)
    flat_kf = jnp.broadcast_to(kf2c[:, None], (B, m.N)).reshape(-1)
    flat_kp = jnp.broadcast_to(jnp.arange(m.N)[None, :], (B, m.N)).reshape(-1)
    m, okw = add_observations_multi(m, flat_pt, flat_kf, flat_kp, flat_pt >= 0)
    okw = okw.reshape(B, m.N)
    bind &= okw
    new_rows = jnp.where(bind, cand, existing)
    m = m._replace(
        kf_mp=m.kf_mp.at[jnp.where(nok, kf2c, m.K)].set(new_rows, mode="drop"),
    )
    # Occupied slots: candidate and existing are DUPLICATES of one
    # landmark — MERGE (orbMatcher.cpp:729-737), fewer-obs point dies
    # into the other, which absorbs its observations.  See
    # fuse_into_kf_body for why rebind-without-merge starved the map.
    cand_obs = n_obs_tab[jnp.clip(cand, 0, m.M - 1)]
    exist_obs = n_obs_tab[jnp.clip(existing, 0, m.M - 1)]
    merge = bound & ~empty_slot & (cand != existing)
    old = jnp.where(exist_obs > cand_obs, cand, existing)
    new = jnp.where(exist_obs > cand_obs, existing, cand)
    # COMPACT the merge set before replace_points: the (B,N) candidate
    # grid is ~20k rows but real duplicate merges per fuse are a few
    # dozen, and replace_points' obs-transfer + descriptor refresh costs
    # scale with the ROW COUNT, not the merge count (measured: the dense
    # 20k-row call alone put fuse at ~50 ms/keyframe device time, 6x the
    # whole r4 prep budget).  Merges past the budget are simply caught
    # at the next keyframe's fuse pass — the reference's sequential loop
    # has no such bound but also no batching to pay for.
    mf = merge.reshape(-1)
    sel = jnp.argsort(~mf, stable=True)[:FUSE_MERGE_BUDGET]
    ok_sel = mf[sel]
    m = replace_points(
        m, jnp.where(ok_sel, old.reshape(-1)[sel], -1),
        new.reshape(-1)[sel], ok_sel, scale_factor, n_levels,
    )
    # ---------------- IN: each neighbor -> kf1 ----------------
    # Fresh obs counts: the OUT pass just added/erased observations, and
    # the IN pass's replace-direction heuristic (c_obs > e_obs) should
    # see them — matching the reference's sequential loop, which always
    # reads current counts (localMapping.cpp:253-294).
    n_obs_tab = jnp.sum(m.mp_obs_kf >= 0, axis=-1)
    idsB = m.kf_mp[kf2c]  # (B,N)
    a_attr_i, b_attr_i = jax.vmap(
        lambda k2: _fuse_attrs(m, k2, kf1, cam, scale_factor, n_levels)
    )(kf2c)
    desc_a_i = m.mp_desc[jnp.clip(idsB, 0, m.M - 1)]  # (B,N,8)
    desc_b_i = jnp.broadcast_to(m.kf_desc[kf1][None], (B, m.N, 8))
    ((idx_i, b1_i, _),) = best2(
        desc_a_i, a_attr_i, desc_b_i, b_attr_i, "fuse"
    )
    bound_i, cand_i, dist_i = jax.vmap(
        lambda i, d1, act, ids: _fuse_select(i, d1, act, ids, m.N)
    )(idx_i, b1_i, nok, idsB)
    dmat = jnp.where(bound_i, dist_i, INVALID_DIST)
    win = jnp.argmin(dmat, axis=0)  # (N,) winning neighbor per kf1 kp
    win_d = jnp.take_along_axis(dmat, win[None, :], axis=0)[0]
    j_bound = win_d < INVALID_DIST
    j_cand = jnp.take_along_axis(cand_i, win[None, :], axis=0)[0]
    # One binding per point: keep the lowest dst keypoint index per mp.
    j_idx = jnp.arange(m.N)
    first_j = jnp.full((m.M + 1,), m.N, jnp.int32).at[
        jnp.where(j_bound, jnp.clip(j_cand, 0, m.M - 1), m.M)
    ].min(j_idx.astype(jnp.int32), mode="drop")
    j_bound &= first_j[jnp.clip(j_cand, 0, m.M - 1)] == j_idx
    from .map_state import obs_has_free as _ohf

    existing1 = m.kf_mp[kf1]
    empty1 = existing1 < 0
    bind1 = j_bound & empty1 & _ohf(m, j_cand)
    new_row1 = jnp.where(bind1, j_cand, existing1)
    m = m._replace(kf_mp=m.kf_mp.at[kf1].set(new_row1))
    m = add_observations(
        m, jnp.where(bind1, j_cand, -1), kf1, j_idx, bind1
    )
    # Occupied slots merge, same as the OUT pass.  n_obs is re-read:
    # the OUT pass's merges changed counts.
    n_obs2 = jnp.sum(m.mp_obs_kf >= 0, axis=-1)
    c_obs = n_obs2[jnp.clip(j_cand, 0, m.M - 1)]
    e_obs = n_obs2[jnp.clip(existing1, 0, m.M - 1)]
    merge1 = j_bound & ~empty1 & (j_cand != existing1)
    old1 = jnp.where(e_obs > c_obs, j_cand, existing1)
    new1 = jnp.where(e_obs > c_obs, existing1, j_cand)
    sel1 = jnp.argsort(~merge1, stable=True)[:FUSE_MERGE_BUDGET]
    ok1 = merge1[sel1]
    return replace_points(
        m, jnp.where(ok1, old1[sel1], -1), new1[sel1], ok1,
        scale_factor, n_levels,
    )
