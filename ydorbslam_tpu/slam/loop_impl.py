"""LoopCloser implementation: detection -> Sim3 -> correction -> global BA.

The algorithmic mirror of src/loopClosing.cpp with the thread protocol
removed (SURVEY.md §2c P3/P7: the transient global-BA thread and
stop/release handshakes become a synchronous call after correction).

Pipeline per keyframe (gates identical to the reference):
  detect   — retrieval candidates (slam/retrieval.py) + covisibility
             consistency across 3 consecutive keyframes
             (loopClosing.cpp:34-114),
  verify   — dense descriptor match between the two keyframes' map
             points (>= 20), vmapped Horn RANSAC, Sim3 refinement
             (>= 20 inliers), guided projection against the loop
             group's points (>= 40 total) (loopClosing.cpp:115-228),
  correct  — propagate the corrected Sim3 to the covisible group and
             its points, fuse duplicates, optimize the essential graph,
             run global BA (loopClosing.cpp:229-337, 377-445).
"""
from __future__ import annotations

from typing import List, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.se3 import inv_T
from ..geometry.sim3 import inv_S, sim3_to_se3
from ..optim.horn import ransac_sim3
from ..optim.pose_graph import PoseGraphProblem, optimize_pose_graph
from ..optim.schur import BAProblem, bundle_adjust
from ..optim.sim3_opt import optimize_sim3
from .map_state import MapState
from .matchers import match_dense, match_local_points
from .retrieval import add_keyframe as retr_add
from .retrieval import bow_histogram, detect_candidates, score_all


import functools


def _fetch(x):
    """THE device->host fetch gate of loop verification/correction.

    Every host pull in the verify/correct path routes through here so
    the budget is enforceable: tests/test_loop_fetch_budget.py blocks
    direct array exports and asserts <= 2 _fetch calls per loop event
    (one packed verification vector, one correction bundle)."""
    return jax.device_get(x)


@functools.partial(
    jax.jit,
    static_argnames=(
        "th_low", "ratio", "n_hypotheses", "min_inliers", "sim3_iters",
        "scale_factor", "n_levels", "guided_cap",
    ),
)
def _verify_pack(
    m: MapState, kf1, kf2, key, cam,
    th_low: int, ratio: float, n_hypotheses: int, min_inliers: int,
    sim3_iters: int, scale_factor: float, n_levels: int, guided_cap: int,
):
    """Fused geometric verification (loopClosing.cpp:115-228): dense
    appearance match -> Horn RANSAC -> Sim3 refinement -> guided
    projection, ONE program.  Returns (pack, matched_mp): ``pack`` is
    the (22,) gate vector [n_matches, ransac_ok, n_sim3_inliers,
    n_guided_total, n_has1, n_has2, S_ref(16)] — the ONLY host fetch of
    verification (has1/has2 = keypoints with live map points on each
    side, the bow-gate's input budget; recorded for gate diagnostics) —
    and ``matched_mp`` (N,) is the guided loop-point assignment per kf1
    keypoint (the reference's m_v_matchedMapPoints,
    loopClosing.cpp:196-227), which stays on device and feeds the
    correction's point binding (loopClosing.cpp:295-305).
    """
    from ..ops.extractor import FrameFeatures

    # 1. appearance match restricted to keypoints WITH map points
    has1 = m.kf_kp_valid[kf1] & (m.kf_mp[kf1] >= 0)
    has2 = m.kf_kp_valid[kf2] & (m.kf_mp[kf2] >= 0)
    assign, _ = match_dense(
        m.kf_desc[kf1], has1, m.kf_angle[kf1],
        m.kf_desc[kf2], has2, m.kf_angle[kf2],
        max_dist=th_low, ratio=ratio,
    )  # per kf2-keypoint -> kf1-keypoint
    n_matches = jnp.sum(assign >= 0)
    kp2 = jnp.arange(m.N)
    kp1 = jnp.clip(assign, 0, m.N - 1)
    ok = assign >= 0
    mp1 = m.kf_mp[kf1, kp1]
    mp2 = m.kf_mp[kf2, kp2]
    ok &= (mp1 >= 0) & (mp2 >= 0)
    ok &= m.mp_valid[jnp.clip(mp1, 0, m.M - 1)]
    ok &= m.mp_valid[jnp.clip(mp2, 0, m.M - 1)]
    T1, T2 = m.kf_pose[kf1], m.kf_pose[kf2]
    p1 = m.mp_pos[jnp.clip(mp1, 0, m.M - 1)] @ T1[:3, :3].T + T1[:3, 3]
    p2 = m.mp_pos[jnp.clip(mp2, 0, m.M - 1)] @ T2[:3, :3].T + T2[:3, 3]
    sf2 = (scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)) ** 2
    s2_1 = sf2[m.kf_octave[kf1, kp1]]
    s2_2 = sf2[m.kf_octave[kf2, kp2]]
    # 2. Horn RANSAC (scale fixed: stereo/RGB-D, loopClosing.cpp:132)
    res = ransac_sim3(
        key, cam, p1, p2, s2_1, s2_2, ok,
        n_hypotheses=n_hypotheses, min_inliers=min_inliers,
    )
    # 3. Sim3 refinement on inlier observations (optimizeSim3)
    S_ref, inl, n_in = optimize_sim3(
        cam, res.S_12, p1, p2, m.kf_uv[kf1, kp1], m.kf_uv[kf2, kp2],
        1.0 / s2_1, 1.0 / s2_2, res.inliers,
        iters1=sim3_iters, iters2=10,
    )
    # 4. guided projection against the loop group's points
    # (searchByProjectionInSim, loopClosing.cpp:196-227): group = kf2 +
    # its 10 strongest covisibles; member points via scatter mask.
    w = m.covis[kf2] * m.kf_valid.astype(jnp.int32)
    nvals, nids = jax.lax.top_k(w, 10)
    gsel = jnp.zeros((m.K,), bool).at[
        jnp.where(nvals > 0, nids, m.K)
    ].set(nvals > 0, mode="drop").at[kf2].set(True)
    kf_sel = gsel[:, None] & (m.kf_mp >= 0)
    member = jnp.zeros((m.M,), bool).at[
        jnp.clip(m.kf_mp, 0, m.M - 1)
    ].max(kf_sel, mode="drop") & m.mp_valid
    order = jnp.where(member, jnp.arange(m.M), m.M)
    pts = jnp.sort(order)[:guided_cap].astype(jnp.int32)
    pvalid = pts < m.M
    idc = jnp.clip(pts, 0, m.M - 1)
    S_cw = S_ref @ m.kf_pose[kf2]
    T_cw = sim3_to_se3(S_cw)
    feats = FrameFeatures(
        uv=m.kf_uv[kf1], uv_raw=m.kf_uv[kf1],
        response=jnp.zeros((m.N,)), octave=m.kf_octave[kf1],
        angle=m.kf_angle[kf1], desc=m.kf_desc[kf1],
        right_u=m.kf_right_u[kf1], depth=m.kf_depth[kf1],
        valid=m.kf_kp_valid[kf1],
    )
    gassign, _ = match_local_points(
        cam, feats, T_cw,
        m.mp_pos[idc], m.mp_desc[idc], m.mp_normal[idc],
        m.mp_max_dist[idc], m.mp_min_dist[idc], pvalid & m.mp_valid[idc],
        th=2.0, n_levels=n_levels, scale_factor=scale_factor,
    )
    total = jnp.sum(gassign >= 0)
    matched_mp = jnp.where(
        gassign >= 0, pts[jnp.clip(gassign, 0, pts.shape[0] - 1)], -1
    ).astype(jnp.int32)
    pack = jnp.concatenate([
        jnp.stack([
            n_matches.astype(jnp.float32),
            res.ok.astype(jnp.float32),
            n_in.astype(jnp.float32),
            total.astype(jnp.float32),
            jnp.sum(has1).astype(jnp.float32),
            jnp.sum(has2).astype(jnp.float32),
        ]),
        S_ref.reshape(16),
    ])
    return pack, matched_mp


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_out", "consistency_th", "n_banks", "bank_bits",
        "min_frame_gap",
    ),
)
def _detect_on_device(
    m: MapState, retrieval, kf_id, prev_masks, prev_counts,
    max_out: int, consistency_th: int,
    n_banks: int = 4, bank_bits: int = 12, min_frame_gap: int = 0,
):
    """Fused loop-candidate detection + covisibility-consistency update.

    One program covers KeyFrameDatabase::detectLoopCandidates gating
    (query histogram, min covisible score, candidate filter) AND the
    consistency-group tracking of loopClosing.cpp:73-113: each
    candidate's covisibility group is intersected with the previous
    keyframe's groups on device; only the per-candidate "consistent
    enough" flags cross to the host.
    """
    q = bow_histogram(
        m.kf_desc[kf_id], m.kf_kp_valid[kf_id], n_banks, bank_bits
    )
    _, scores = score_all(retrieval, q)
    return _detect_body(
        m, retrieval, kf_id, prev_masks, prev_counts, q, scores,
        max_out, consistency_th, min_frame_gap,
    )


def make_sharded_detect(mesh, max_out, consistency_th, n_banks, bank_bits,
                        min_frame_gap=0):
    """Production detection with KEYFRAME-SHARDED retrieval scoring.

    Same program as _detect_on_device except the score pass runs as a
    shard_map over the mesh (parallel.retrieval_sharded.score_all_sharded
    — bit-exact with score_all); every gate downstream is shared code.
    Built per mesh because Mesh objects cannot cross the jit boundary
    as arguments.
    """
    from ..parallel.retrieval_sharded import score_all_sharded

    @jax.jit
    def detect(m, retrieval, kf_id, prev_masks, prev_counts):
        q = bow_histogram(
            m.kf_desc[kf_id], m.kf_kp_valid[kf_id], n_banks, bank_bits
        )
        _, scores = score_all_sharded(mesh, retrieval, q)
        return _detect_body(
            m, retrieval, kf_id, prev_masks, prev_counts, q, scores,
            max_out, consistency_th, min_frame_gap,
        )

    return detect


def _detect_body(
    m, retrieval, kf_id, prev_masks, prev_counts, q, scores,
    max_out, consistency_th, min_frame_gap=0,
):
    connected = (m.covis[kf_id] > 0).at[kf_id].set(True)
    neigh = connected & (jnp.arange(m.K) != kf_id) & retrieval.valid
    min_score = jnp.min(jnp.where(neigh, scores, jnp.inf))
    min_score = jnp.where(jnp.isfinite(min_score), min_score, 0.0)
    ids, _ = detect_candidates(
        retrieval, q, connected, m.covis, min_score, max_out=max_out
    )
    # Temporal wrong-pair guard (see LoopConfig.min_frame_gap): a
    # candidate minted within the gap of the query frame is a
    # lost-stretch neighbor, not a revisit — covisibility disconnection
    # alone cannot tell the two apart.
    if min_frame_gap > 0:
        idg = jnp.clip(ids, 0, m.K - 1)
        gap_ok = jnp.abs(
            m.kf_frame_id[idg] - m.kf_frame_id[kf_id]
        ) >= min_frame_gap
        ids = jnp.where(gap_ok, ids, -1)
    # Consistency groups: candidate group = candidate + its covisibles.
    idc = jnp.clip(ids, 0, m.K - 1)
    masks = (m.covis[idc] > 0) | jax.nn.one_hot(idc, m.K, dtype=bool)
    masks &= (ids >= 0)[:, None]
    inter = jnp.einsum("ck,gk->cg", masks, prev_masks)  # counts > 0 = hit
    best_prev = jnp.max(
        jnp.where(inter > 0, prev_counts[None, :] + 1, 0), axis=-1,
        initial=0,
    )
    consistent = (ids >= 0) & (best_prev >= consistency_th)
    return ids, consistent, masks, best_prev


@jax.jit
def _merge_gba(m: MapState, T_new, p_new, pts, valid0, fid0, kf_count_start):
    """Merge a finished (possibly long-running) global BA into the LIVE
    map — the reference's post-BA spanning-tree propagation
    (loopClosing.cpp:377-445): keyframes that existed when the BA
    started take their optimized pose directly; keyframes inserted
    DURING the BA window chain off their spanning-tree parent
    (T_child<-w = T_child<-parent_old @ T_parent_old^-1 @ T_parent_new);
    points follow either their own optimized position or their reference
    keyframe's correction.  Slot-reuse staleness is guarded by the
    frame-id snapshot ``fid0``: a keyframe culled + re-minted during the
    BA is treated as new (chained), never overwritten with the stale
    optimum.  ONE device program, zero host fetches.
    """
    K = m.K
    T_now = m.kf_pose
    same = m.kf_valid & valid0 & (m.kf_frame_id == fid0)
    T_merged = jnp.where(same[:, None, None], T_new[:K], T_now)
    parc = jnp.clip(m.parent, 0, K - 1)
    # T_child_old @ T_parent_old^-1, frozen relative pose per keyframe.
    T_rel = jnp.einsum("kij,kjl->kil", T_now, inv_T(T_now[parc]))

    def body(_, carry):
        T_m, res = carry
        can = m.kf_valid & ~res & (m.parent >= 0) & res[parc]
        prop = jnp.einsum("kij,kjl->kil", T_rel, T_m[parc])
        T_m = jnp.where(can[:, None, None], prop, T_m)
        return T_m, res | can

    # Spanning-tree edges point to older keyframes; keyframes minted
    # during one BA window form chains of bounded depth — 8 propagation
    # rounds cover any realistic window (each round resolves one tree
    # level below the already-resolved frontier).
    T_merged, resolved = jax.lax.fori_loop(0, 8, body, (T_merged, same))
    kf_pose = jnp.where(
        (m.kf_valid & resolved)[:, None, None], T_merged, T_now
    )

    # Points optimized by the BA write back directly — unless their slot
    # was culled + reused during the window (first_kf moved past the BA
    # start count).
    ptc = jnp.clip(pts, 0, m.M - 1)
    direct_ok = (
        (pts >= 0) & m.mp_valid[ptc] & (m.mp_first_kf[ptc] < kf_count_start)
    )
    row_w = jnp.where(direct_ok, ptc, m.M)
    direct_mask = jnp.zeros((m.M,), bool).at[row_w].set(True, mode="drop")
    mp_pos = m.mp_pos.at[row_w].set(
        jnp.where(direct_ok[:, None], p_new, m.mp_pos[ptc]), mode="drop"
    )
    # Everything else follows its reference keyframe's correction
    # (loopClosing.cpp:419-436).
    refc = jnp.clip(m.mp_ref_kf, 0, K - 1)
    T_ref_old = T_now[refc]
    T_ref_new = kf_pose[refc]
    p_cam = (
        jnp.einsum("nij,nj->ni", T_ref_old[:, :3, :3], m.mp_pos)
        + T_ref_old[:, :3, 3]
    )
    Tinv = inv_T(T_ref_new)
    p_ind = (
        jnp.einsum("nij,nj->ni", Tinv[:, :3, :3], p_cam) + Tinv[:, :3, 3]
    )
    ind_ok = (
        m.mp_valid & ~direct_mask & (m.mp_ref_kf >= 0)
        & resolved[refc] & m.kf_valid[refc]
    )
    mp_pos = jnp.where(ind_ok[:, None], p_ind, mp_pos)
    return m._replace(kf_pose=kf_pose, mp_pos=mp_pos)


def _fuse_match_into_kf(m: MapState, g, pts, pvalid, cam,
                        scale_factor: float, n_levels: int):
    """fuseBySim3 candidate search for ONE target keyframe
    (src/orbMatcher.cpp:746-807): project the loop points with the
    target's (already corrected) pose; gates = in front + in image,
    distance in [0.8*min, 1.2*max] invariance band, view-cos >= 0.5,
    radius 4*scale^pred window, octave in [pred-1, pred], best Hamming
    <= TH_LOW, no ratio test, no rotation histogram.

    Returns per-keypoint candidate index into ``pts`` (-1 = none).
    """
    from ..ops.extractor import FrameFeatures
    from .matchers import (TH_LOW, predict_scale_level, project_sources,
                          search_by_projection)

    idc = jnp.clip(pts, 0, m.M - 1)
    T = m.kf_pose[g]
    pos = m.mp_pos[idc]
    proj = project_sources(cam, T, pos, pvalid & m.mp_valid[idc])
    cam_center = -T[:3, :3].T @ T[:3, 3]
    po = pos - cam_center[None]
    dist = jnp.linalg.norm(po, axis=-1)
    view_cos = jnp.sum(po * m.mp_normal[idc], axis=-1) / jnp.maximum(
        dist * jnp.linalg.norm(m.mp_normal[idc], axis=-1), 1e-6
    )
    band_ok = (dist >= 0.8 * m.mp_min_dist[idc]) & (
        dist <= 1.2 * m.mp_max_dist[idc]
    )
    proj = proj._replace(valid=proj.valid & band_ok & (view_cos >= 0.5))
    pred = predict_scale_level(
        dist, 1.2 * m.mp_max_dist[idc], n_levels, scale_factor
    )
    scales = scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)
    radius = 4.0 * scales[pred]
    feats = FrameFeatures(
        uv=m.kf_uv[g], uv_raw=m.kf_uv[g],
        response=jnp.zeros((m.N,)), octave=m.kf_octave[g],
        angle=m.kf_angle[g], desc=m.kf_desc[g],
        right_u=m.kf_right_u[g], depth=m.kf_depth[g],
        valid=m.kf_kp_valid[g],
    )
    assign, _ = search_by_projection(
        feats, m.mp_desc[idc], proj, radius, pred - 1, pred,
        max_dist=TH_LOW, ratio=None, src_angle=None, check_ur=False,
    )
    return assign


def _bind_points_into_kf(m: MapState, g, q: jax.Array,
                         scale_factor: float, n_levels: int) -> MapState:
    """Bind/replace candidate points ``q`` (N,) into keyframe ``g``:
    empty keypoint slots bind (addObservation + addMapPoint,
    loopClosing.cpp:299-303), occupied slots hand their existing point
    to the candidate via beReplacedBy (loopClosing.cpp:297, 344-350 —
    the loop-side point SURVIVES, absorbing the current-side point's
    observations; this is what creates cross-loop covisibility)."""
    from .map_state import add_observations_multi, replace_points

    qc = jnp.clip(q, 0, m.M - 1)
    already = jnp.any(m.mp_obs_kf[qc] == g, axis=-1)  # q already in g
    vq = (q >= 0) & m.mp_valid[qc] & ~already
    p_exist = m.kf_mp[g]
    bind = vq & (p_exist < 0)
    repl = vq & (p_exist >= 0) & (p_exist != q)
    kp_idx = jnp.arange(m.N, dtype=jnp.int32)
    m, okw = add_observations_multi(
        m, jnp.where(bind, q, -1),
        jnp.full((m.N,), 1, jnp.int32) * g, kp_idx, bind,
    )
    m = m._replace(
        kf_mp=m.kf_mp.at[g].set(jnp.where(bind & okw, q, p_exist))
    )
    return replace_points(
        m, jnp.where(repl, p_exist, -1), q, repl, scale_factor, n_levels
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "scale_factor", "n_levels", "fuse_pts_cap", "fuse_group_cap",
    ),
)
def _correct_on_device(
    m: MapState, kf1, kf2, S_12, matched_mp, cam,
    scale_factor: float, n_levels: int,
    fuse_pts_cap: int, fuse_group_cap: int,
):
    """The WHOLE loop correction as one device program
    (loopClosing.cpp:229-352): corrected Sim3 propagated to kf1's
    covisible group and its points; the guided loop-point matches bound
    into kf1 (beReplacedBy / addObservation, :295-305); searchAndFuse
    of the loop-side point set into EVERY corrected-group keyframe
    (:311, :339-352); covisibility rebuilt post-fusion so the host can
    read off the NEW cross-loop links (loopConnections, :311-325).

    Returns (new map, host bundle); the bundle carries everything the
    essential-graph assembly needs — old/corrected poses, group mask,
    PRE- and POST-fusion covisibility, validity, spanning tree, loop
    edges, fuse-group overflow count, and the live point count.
    """
    from .map_state import recompute_covis_all

    covis_before = m.covis
    old_poses = m.kf_pose
    group = ((m.covis[kf1] > 0) & m.kf_valid).at[kf1].set(True)  # (K,)
    S_cw_corr = S_12 @ old_poses[kf2]
    T_old_kf1_inv = inv_T(old_poses[kf1])
    corrected_all = jnp.einsum(
        "kij,jl->kil", old_poses @ T_old_kf1_inv, S_cw_corr
    )  # (K,4,4): corrected Sim3 per keyframe (meaningful where group)

    # Group member points via scatter mask (no host kf_mp pulls).
    kf_sel = group[:, None] & (m.kf_mp >= 0)
    member = jnp.zeros((m.M,), bool).at[
        jnp.clip(m.kf_mp, 0, m.M - 1)
    ].max(kf_sel, mode="drop") & m.mp_valid
    # Each point moves through its reference keyframe's correction when
    # the ref is in the group, else through kf1's (loopClosing.cpp:263-287).
    ref = m.mp_ref_kf
    refc = jnp.clip(ref, 0, m.K - 1)
    use_kf = jnp.where((ref >= 0) & group[refc], refc, kf1)
    S_old = old_poses[use_kf]  # (M,4,4)
    S_new = corrected_all[use_kf]
    p_cam = (
        jnp.einsum("nij,nj->ni", S_old[:, :3, :3], m.mp_pos)
        + S_old[:, :3, 3]
    )
    S_new_inv = inv_T(S_new)  # corrected poses are SE3 (s=1, stereo/RGBD)
    p_corr = (
        jnp.einsum("nij,nj->ni", S_new_inv[:, :3, :3], p_cam)
        + S_new_inv[:, :3, 3]
    )
    mp_pos = jnp.where(member[:, None], p_corr, m.mp_pos)

    kf_pose = jnp.where(
        group[:, None, None], jax.vmap(sim3_to_se3)(corrected_all), old_poses
    )
    new_m = m._replace(
        mp_pos=mp_pos,
        kf_pose=kf_pose,
        loop_edge=m.loop_edge.at[kf1].set(kf2),
    )

    # ---- matched-point binding at kf1 (loopClosing.cpp:295-305) ----
    new_m = _bind_points_into_kf(
        new_m, kf1, matched_mp, scale_factor, n_levels
    )

    # ---- whole-group searchAndFuse (loopClosing.cpp:311, 339-352) ----
    # Loop-side point set: kf2 + ALL its covisibles' points (the
    # reference's m_v_loopMapPoints, loopClosing.cpp:196-204), capped.
    lsel = ((covis_before[kf2] > 0) & new_m.kf_valid).at[kf2].set(True)
    l_kf_sel = lsel[:, None] & (new_m.kf_mp >= 0)
    l_member = jnp.zeros((new_m.M,), bool).at[
        jnp.clip(new_m.kf_mp, 0, new_m.M - 1)
    ].max(l_kf_sel, mode="drop") & new_m.mp_valid
    order = jnp.where(l_member, jnp.arange(new_m.M), new_m.M)
    pts = jnp.sort(order)[:fuse_pts_cap].astype(jnp.int32)
    pvalid = pts < new_m.M
    pts = jnp.where(pvalid, pts, -1)

    # Fuse targets: kf1 + the strongest covisible group members.
    K = new_m.K
    others_w = jnp.where(
        group & (jnp.arange(K) != kf1), covis_before[kf1], -1
    )
    n_others = min(fuse_group_cap - 1, K - 1)
    gvals, gids = jax.lax.top_k(others_w, n_others)
    g_list = jnp.concatenate(
        [jnp.asarray(kf1, jnp.int32)[None], gids.astype(jnp.int32)]
    )
    g_ok = jnp.concatenate([jnp.ones((1,), bool), gvals > 0])
    n_group_skipped = jnp.maximum(
        jnp.sum(group) - jnp.int32(fuse_group_cap), 0
    )

    def fuse_step(mm, gi):
        g, gok = gi
        assign = _fuse_match_into_kf(
            mm, g, pts, pvalid, cam, scale_factor, n_levels
        )
        q = jnp.where(
            (assign >= 0) & gok,
            pts[jnp.clip(assign, 0, pts.shape[0] - 1)], -1,
        )
        return _bind_points_into_kf(mm, g, q, scale_factor, n_levels), None

    new_m, _ = jax.lax.scan(fuse_step, new_m, (g_list, g_ok))

    # ---- post-fusion covisibility (updateConnections sweep) ----
    new_m = recompute_covis_all(new_m)

    bundle = (
        old_poses, corrected_all, group, covis_before, new_m.covis,
        new_m.kf_valid, new_m.parent, new_m.loop_edge, n_group_skipped,
        jnp.sum(new_m.mp_valid),
    )
    return new_m, bundle


class LoopCloserImpl:
    def __init__(self, system, closer):
        self.system = system
        self.closer = closer
        self.key = jax.random.PRNGKey(0)
        # Production sharded retrieval: when several devices are
        # visible, candidate scoring shards the keyframe axis over the
        # mesh (the scaled replacement of the reference's inverted
        # file, keyFrameDatabase.cpp:26-105).  Same gates either way.
        self._sharded_detect = None
        self.used_sharded_detect = False
        self._gba = None  # in-flight global-BA state (see _start_global_ba)
        # One worker thread owns the detection-result fetch, so the
        # device->host wait never lands on the tracking thread.  This is
        # the array-world remnant of the reference's LoopClosing thread
        # (loopClosing.cpp:10-27): compute stays on device, the fetch
        # latency moves off the critical path.
        import concurrent.futures

        self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="loop-fetch"
        )
        from ..parallel.multihost import device_mesh

        K = system.cfg.capacity.max_keyframes
        mesh = device_mesh("kf", length_divisor=K)
        if mesh is not None:
            cfg = system.cfg
            self._sharded_detect = make_sharded_detect(
                mesh,
                cfg.capacity.loop_candidates,
                cfg.loop.covisibility_consistency_th,
                cfg.loop.retrieval_banks,
                cfg.loop.retrieval_bank_bits,
                cfg.loop.min_frame_gap,
            )

    # ------------------------------------------------------------------
    def process(self, kf_id: int) -> bool:
        """Dispatch detection for this keyframe; VERIFY the previous
        keyframe's detection result (its device arrays are materialized
        by now, so the fetch is free).

        The reference's LoopClosing runs in a background thread
        (loopClosing.cpp:10-27) consuming a keyframe queue — it too
        verifies keyframes slightly after insertion.  Polling one
        keyframe late keeps the device pipeline free of sync points:
        a blocking fetch here would stall every queued tracking frame.
        """
        sys = self.system
        cfg = sys.cfg
        closer = self.closer
        self.tick()
        closed = self._poll_pending()
        if sys.n_keyframes - closer.last_loop_kf_count >= cfg.loop.min_kfs_between_loops:
            self._dispatch_detect(kf_id)
        return closed

    def flush(self) -> bool:
        """Verify any still-pending detection and run any in-flight
        global BA to completion (sequence end)."""
        closed = self._poll_pending()
        while self._gba is not None:
            self.tick()
        return closed

    def _dispatch_detect(self, kf_id: int) -> None:
        """Candidate scoring + covisibility-consistency update, one
        device program, NO host fetch (loopClosing.cpp:34-114)."""
        sys = self.system
        m = sys.map
        C = sys.cfg.capacity.loop_candidates
        if not isinstance(self.closer.consistent_groups, tuple):
            self.closer.consistent_groups = (
                jnp.zeros((C, m.K), bool),
                -jnp.ones((C,), jnp.int32),
            )
        prev_masks, prev_counts = self.closer.consistent_groups
        if self._sharded_detect is not None:
            ids, consistent, masks, counts = self._sharded_detect(
                m, sys.retrieval, kf_id, prev_masks, prev_counts
            )
            self.used_sharded_detect = True
        else:
            ids, consistent, masks, counts = _detect_on_device(
                m, sys.retrieval, kf_id, prev_masks, prev_counts,
                C, sys.cfg.loop.covisibility_consistency_th,
                n_banks=sys.cfg.loop.retrieval_banks,
                bank_bits=sys.cfg.loop.retrieval_bank_bits,
                min_frame_gap=sys.cfg.loop.min_frame_gap,
            )
        self.closer.consistent_groups = (masks, counts.astype(jnp.int32))
        # The worker thread absorbs the device->host wait; the
        # poll (one keyframe later) just reads the completed future.
        fut = self._fetch_pool.submit(jax.device_get, (ids, consistent))
        snap = sys._snapshot()
        self._pending = (kf_id, int(snap["kf_frame_id"][kf_id]), fut)

    def _poll_pending(self) -> bool:
        pending = getattr(self, "_pending", None)
        if pending is None:
            return False
        self._pending = None
        kf_id, frame_id_at_dispatch, fut = pending
        sys = self.system
        closer = self.closer
        # Staleness guard: verification runs one keyframe late against a
        # map that kept evolving — if mapping culled the pending
        # keyframe (or culled + reused its slot for a different frame),
        # Sim3 verification would run against another keyframe's data.
        snap = sys._snapshot()
        if (not bool(snap["kf_valid"][kf_id])
                or int(snap["kf_frame_id"][kf_id]) != frame_id_at_dispatch):
            fut.cancel()
            return False
        ids_np, cons_np = fut.result()
        cands = [int(i) for i, c in zip(ids_np, cons_np) if i >= 0 and c]
        if cands:
            sys.stats.loop_candidates += 1
        for cand in cands:
            hit = self._compute_sim3(kf_id, cand)
            if hit is not None:
                S_12, _, matched_mp = hit
                sys.stats.loop_events.append((
                    int(snap["kf_frame_id"][kf_id]),
                    int(snap["kf_frame_id"][cand]),
                    float(jnp.linalg.norm(S_12[:3, 3])),
                ))
                self._correct(kf_id, cand, S_12, matched_mp)
                closer.last_loop_kf_count = sys.n_keyframes
                closer.n_loops_closed += 1
                closer.consistent_groups = []  # re-initialized lazily
                return True
        return False

    # ------------------------------------------------------------------
    def _compute_sim3(self, kf1: int, kf2: int):
        """Geometric verification (loopClosing.cpp:115-228).

        ONE fused device program (appearance match -> Horn RANSAC ->
        Sim3 refinement -> guided projection count) and ONE packed
        device->host fetch; the reference's sequential early-exits
        become host gate checks on the fetched scalars, instead of
        per-candidate host pulls of covis rows / kf_mp lists, each a
        device->host synchronization.

        Returns (S_12 mapping kf2-camera points into kf1 camera, total
        matches) or None.
        """
        sys = self.system
        cfg = sys.cfg
        self.key, sub = jax.random.split(self.key)
        pack_dev, matched_mp = _verify_pack(
            sys.map, kf1, kf2, sub, sys.cam,
            th_low=cfg.matcher.th_low,
            ratio=cfg.matcher.ratio_reloc,
            n_hypotheses=cfg.loop.ransac_max_iters,
            min_inliers=cfg.loop.ransac_min_inliers,
            sim3_iters=cfg.optim.sim3_iters,
            scale_factor=cfg.orb.scale_factor,
            n_levels=cfg.orb.n_levels,
            guided_cap=cfg.capacity.tracking_points,
        )
        pack = _fetch(pack_dev)  # matched_mp stays on device
        n_matches, ransac_ok, n_in, total = (
            int(pack[0]), bool(pack[1] > 0.5), int(pack[2]), int(pack[3])
        )
        fails = sys.stats.loop_verify_fails
        if n_matches < cfg.loop.min_bow_matches:
            fails["bow"] = fails.get("bow", 0) + 1
            # Gate diagnostics: a bow fail with a healthy keypoint
            # budget on both sides is a matcher problem; a starved side
            # is a binding/culling problem (r4 weak #4 diagnosis).
            fails.setdefault("bow_diag", []).append(
                (kf1, kf2, n_matches, int(pack[4]), int(pack[5]))
            )
            return None
        if not ransac_ok:
            fails["ransac"] = fails.get("ransac", 0) + 1
            return None
        if n_in < cfg.loop.min_sim3_inliers:
            fails["sim3"] = fails.get("sim3", 0) + 1
            return None
        if total < cfg.loop.min_total_matches:
            fails["guided"] = fails.get("guided", 0) + 1
            return None
        S_ref = jnp.asarray(pack[6:22].reshape(4, 4))
        return S_ref, total, matched_mp

    # ------------------------------------------------------------------
    def _correct(self, kf1: int, kf2: int, S_12, matched_mp) -> None:
        """Loop correction (loopClosing.cpp:229-352) + global BA.

        ONE device program runs the ENTIRE correction — group Sim3
        propagation, guided-match binding at kf1, whole-group
        searchAndFuse of the loop-side points, post-fusion covisibility
        rebuild (the reference walks these one mutex-guarded object at
        a time; per-member device traffic would synchronize the host
        each time) — and ONE bundled fetch pulls
        everything the host-side essential-graph assembly needs,
        including the pre/post-fusion covisibility pair that yields the
        loopConnections edge set.
        """
        sys = self.system
        cfg = sys.cfg
        new_m, bundle = _correct_on_device(
            sys.map, kf1, kf2, S_12, matched_mp, sys.cam,
            scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
            fuse_pts_cap=cfg.capacity.loop_fuse_points,
            fuse_group_cap=cfg.capacity.loop_fuse_group,
        )
        sys.map = new_m
        (old_np, corrected_np, group_np, covis_before_np, covis_after_np,
         kf_valid_np, parent_np, loop_edge_np, n_group_skipped,
         n_valid_pts) = _fetch(bundle)
        if int(n_group_skipped) > 0:
            print(
                f"[loop] searchAndFuse: corrected group exceeds "
                f"capacity.loop_fuse_group by {int(n_group_skipped)} "
                f"keyframes; weakest-covisibility members not fused"
            )

        # Essential graph over all keyframes (host assembly from the
        # prefetched bundle; device solve).
        sys.map = self._essential_graph(
            sys.map, kf1, kf2, old_np, corrected_np, group_np,
            covis_before_np, covis_after_np, kf_valid_np, parent_np,
            loop_edge_np,
        )

        # Global BA (10 iterations, loopClosing.cpp:380) — STARTED here,
        # not run: LM chunks are dispatched one per drained frame batch
        # (``tick``), overlapping the solve with tracking exactly like
        # the reference's transient BA thread (loopClosing.cpp:334).
        self._start_global_ba(sys.map, int(n_valid_pts))
        # Trajectory records referenced to pre-correction keyframe poses
        # stay valid: T_c_ref composes with the corrected keyframe pose.

    def _essential_graph(
        self, m: MapState, kf1, kf2, old_np, corrected_np, group_np,
        covis_before_np, covis_after_np, kf_valid_np, parent_np,
        loop_edge_np,
    ):
        """Essential-graph optimization (optimizer.cpp:502-661).  Edge
        assembly is host Python over the PREFETCHED bundle (zero
        additional device traffic); the Sim3 solve runs on device.

        Edge set, in insertion order (first insertion of a pair wins):
          1. loopConnections — covisibility links that are NEW since the
             fusion (weight >= essential_min_covis_weight post-fusion,
             not connected pre-fusion, one endpoint in the corrected
             group, the other outside), measured with CORRECTED poses
             (loopClosing.cpp:311-325 + optimizer.cpp:547-563).  These
             are the cross-loop anchors; without them one bridging edge
             would pull the whole graph.
          2. spanning tree + prior loop edges, measured with the
             non-corrected poses (optimizer.cpp:565-605).
          3. strong covisibility (weight >= 100 POST-fusion), measured
             non-corrected (optimizer.cpp:606-625).
        """
        cfg = self.system.cfg
        K = m.K
        kf_valid = kf_valid_np
        parent = parent_np
        loop_edge = loop_edge_np
        old_npl = old_np
        ei, ej, meas, w = [], [], [], []
        inserted = set()

        def add_edge(i, j, weight, use_corrected=False):
            if i < 0 or j < 0 or i == j or not (kf_valid[i] and kf_valid[j]):
                return
            key = (min(i, j), max(i, j))
            if key in inserted:
                return
            inserted.add(key)
            if use_corrected:
                Si = corrected_np[i] if group_np[i] else old_npl[i]
                Sj = corrected_np[j] if group_np[j] else old_npl[j]
            else:
                Si, Sj = old_npl[i], old_npl[j]
            ei.append(i)
            ej.append(j)
            meas.append(Si @ np.linalg.inv(Sj))
            w.append(weight)

        # 1. loopConnections (new cross-loop links).  "Connected" uses
        # the reference's updateConnections threshold (15,
        # keyFrame.cpp:37-96) for the was-connected test; the edge
        # itself needs the essential weight (optimizer.cpp:550).
        wmin = cfg.optim.essential_min_covis_weight
        new_link = np.argwhere(
            (covis_after_np >= wmin)
            & (covis_before_np < 15)
            & group_np[:, None]
            & ~group_np[None, :]
        )
        for i, j in new_link:
            add_edge(int(i), int(j), 1.0, use_corrected=True)
        self.system.stats.loop_conn_edges.append(int(len(new_link)))

        # 2. spanning tree + prior loop edges.
        for i in range(K):
            if not kf_valid[i]:
                continue
            add_edge(i, int(parent[i]), 1.0)
            if loop_edge[i] >= 0:
                add_edge(i, int(loop_edge[i]), 1.0, use_corrected=(i == kf1))
        # 3. strong-covisibility edges (weight >= 100, optimizer.cpp:608),
        # post-fusion weights.
        strong = np.argwhere(
            np.triu(covis_after_np, 1) >= wmin
        )
        for i, j in strong:
            add_edge(int(i), int(j), 1.0)
        if not ei:
            return m
        E = len(ei)
        # Current (post-correction) poses as initial values.
        prob = PoseGraphProblem(
            S_iw=m.kf_pose,
            fixed=jnp.zeros(K, bool).at[kf2].set(True),
            vertex_valid=m.kf_valid,
            edge_i=jnp.asarray(ei, jnp.int32),
            edge_j=jnp.asarray(ej, jnp.int32),
            edge_meas=jnp.asarray(np.stack(meas).astype(np.float32)),
            edge_valid=jnp.ones(E, bool),
            edge_weight=jnp.ones(E),
        )
        S_opt = optimize_pose_graph(
            prob, iters=cfg.optim.essential_graph_iters, fix_scale=True
        )
        # Map points follow their reference keyframe's correction
        # (optimizer.cpp:630-661).
        ref = jnp.clip(m.mp_ref_kf, 0, K - 1)
        S_old_ref = m.kf_pose[ref]
        S_new_ref = S_opt[ref]
        p_cam = (
            jnp.einsum("nij,nj->ni", S_old_ref[:, :3, :3], m.mp_pos)
            + S_old_ref[:, :3, 3]
        )
        S_inv = inv_T(S_new_ref)  # fix_scale=True -> rigid
        p_new = (
            jnp.einsum("nij,nj->ni", S_inv[:, :3, :3], p_cam) + S_inv[:, :3, 3]
        )
        mp_pos = jnp.where(
            (m.mp_valid & (m.mp_ref_kf >= 0))[:, None], p_new, m.mp_pos
        )
        T_new = jax.vmap(sim3_to_se3)(S_opt)
        kf_pose = jnp.where(m.kf_valid[:, None, None], T_new, m.kf_pose)
        return m._replace(kf_pose=kf_pose, mp_pos=mp_pos)

    def _start_global_ba(self, m: MapState, n_valid: int) -> None:
        """Arm the full-map BA (globalBundleAdjust, optimizer.cpp:353-357)
        WITHOUT running it: the problem is gathered from the current map
        and stashed; ``tick`` dispatches bounded LM chunks (one per
        drained frame batch) and ``_finish_gba`` merges the result into
        the then-current map — the array re-expression of the
        reference's transient global-BA thread + post-BA spanning-tree
        merge (loopClosing.cpp:334, 377-445).

        Point budget: ``capacity.global_ba_max_points``, selected by
        OBSERVATION COUNT when the map exceeds it (the best-constrained
        landmarks carry the solve; overflow is logged, never silent).
        Observations per point are compacted to ``global_ba_obs`` slots.
        On a multi-device mesh the chunks run map-block-partitioned
        (points sharded, psum-reduced camera system — SURVEY.md §2c P6).
        A NEW accepted loop while a BA is in flight replaces it — the
        reference aborts the running thread the same way
        (loopClosing.cpp:234-242)."""
        sys = self.system
        sys.stats.global_ba_runs += 1
        cfg = sys.cfg
        from .mapping import build_local_ba

        K = m.K
        win = jnp.where(m.kf_valid, jnp.arange(K, dtype=jnp.int32), -1)
        fixed = -jnp.ones((1,), jnp.int32)
        pts_cap = min(cfg.capacity.global_ba_max_points, m.M)
        n_obs_tab = jnp.sum(m.mp_obs_kf >= 0, axis=-1)
        if n_valid > pts_cap:
            print(
                f"[loop] global BA: map has {n_valid} points, optimizing "
                f"the {pts_cap} best-observed (capacity."
                f"global_ba_max_points); the rest follow their reference "
                f"keyframes' correction"
            )
        rank = jnp.where(m.mp_valid, n_obs_tab, -1)
        _, pts = jax.lax.top_k(rank, pts_cap)
        pts = jnp.where(
            jnp.take(rank, pts) >= 0, pts.astype(jnp.int32), -1
        )
        prob, _ = build_local_ba(
            m, win, fixed, pts, sys.inv_sigma2_tab,
            obs_cap=cfg.capacity.global_ba_obs,
        )
        from ..parallel.multihost import device_mesh

        self._gba = dict(
            prob=prob, pts=pts,
            T=prob.T_cw, p=prob.p_w, lam=jnp.float32(1e-4),
            done=0, iters=cfg.optim.global_ba_iters, chunk=5,
            mesh=device_mesh("pts"),
            # Staleness/merge snapshots.  COPIES, not references: the
            # live map buffers are donated to the next mapping_step and
            # would be deleted under this dict's feet.
            valid0=jnp.copy(m.kf_valid), fid0=jnp.copy(m.kf_frame_id),
            kf_count0=jnp.int32(sys.n_keyframes),
        )

    def tick(self) -> None:
        """Advance any in-flight global BA by ONE LM chunk (async
        dispatch, no host sync) and merge when done.  Called at every
        drained frame batch — this is what overlaps the solve with
        tracking (SURVEY.md §2c P3)."""
        g = self._gba
        if g is None:
            return
        sys = self.system
        should_abort = getattr(self.closer, "should_abort_ba", None)
        if g["mesh"] is not None:
            from ..parallel.ba_sharded import _sharded_lm_chunk

            step = _sharded_lm_chunk(g["mesh"], g["chunk"], True)
            prob = g["prob"]
            g["T"], g["p"], g["lam"] = step(
                sys.cam, g["T"], prob.cam_fixed, prob.cam_valid, g["p"],
                prob.pt_valid, prob.obs_cam, prob.obs_uvr,
                prob.obs_inv_sigma2, prob.obs_stereo, prob.obs_valid,
                g["lam"],
            )
        else:
            from ..optim.schur import _lm_chunk

            g["T"], g["p"], g["lam"] = _lm_chunk(
                sys.cam, g["prob"], g["T"], g["p"], g["lam"],
                chunk=g["chunk"],
            )
        g["done"] += g["chunk"]
        aborted = (
            should_abort is not None
            and g["done"] < g["iters"]
            and should_abort()
        )
        if g["done"] >= g["iters"] or aborted:
            self._finish_gba()

    def _finish_gba(self) -> None:
        """Apply the finished global BA to the LIVE map via the one-shot
        merge program (``_merge_gba``): direct pose/point write-back for
        state that existed at BA start, spanning-tree chaining for
        keyframes minted during the window (loopClosing.cpp:377-445)."""
        g = self._gba
        self._gba = None
        sys = self.system
        sys.map = _merge_gba(
            sys.map, g["T"], g["p"], g["pts"], g["valid0"], g["fid0"],
            g["kf_count0"],
        )
