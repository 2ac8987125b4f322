"""Device-resident pipelined tracking: one dispatch, zero syncs per frame.

Why this exists: the synchronous Tracker (slam/tracking.py) reads
several scalars per frame to drive its state machine — correct, but
every read is a host<->device synchronization that leaves the device
idle while the host decides.  This module moves the WHOLE per-frame
state machine into one jitted step over a device-resident ``TrackState``:

  * extraction, depth association, motion-model matching (both window
    widths computed, selected by match count), pose LM, local-map
    matching + LM, the keyframe-decision counters — all inside one
    program; the tracking mode (INIT/OK/LOST) is itself device state
    driven by ``lax`` selects;
  * a small ``FrameInfo`` result is fetched ASYNCHRONOUSLY and inspected
    a few frames late, so the device never waits for the host;
  * recent frames' features live in an on-device ring buffer; when the
    (lagging) host sees ``need_kf`` it inserts that ring slot as a
    keyframe and runs the mapping pipeline — the exact role of the
    reference's LocalMapping thread queue (src/localMapping.cpp:63,
    SURVEY.md §2c P1), re-expressed as dispatch-ahead instead of
    threads.

Relocalization stays on host (rare; a stall there is acceptable).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import CameraIntrinsics, backproject
from ..geometry.se3 import inv_T
from ..ops.extractor import FrameFeatures, extract_orb
from ..ops.stereo import fill_depth_from_rgbd
from ..optim.pose import PoseObservations, optimize_pose
from .matchers import match_dense, match_local_points, match_motion_model_two

MODE_INIT = 0
MODE_OK = 1
MODE_LOST = 2

RING = 16  # on-device frame ring size (frames + packed info)


class TrackSet(NamedTuple):
    """Local tracking map snapshot (refreshed by host after keyframes)."""

    pts: jax.Array  # (P,) global map-point ids
    pos: jax.Array  # (P,3)
    desc: jax.Array  # (P,8)
    normal: jax.Array  # (P,3)
    dmax: jax.Array  # (P,)
    dmin: jax.Array  # (P,)
    valid: jax.Array  # (P,)
    # scalar: ref-KF tracked count ALREADY multiplied by the reference
    # ratio (0.4 when <2 keyframes exist, else 0.75 — tracking.cpp:
    # 755-760); precomputed at tracking-set refresh so the device step
    # needs no keyframe-count input.
    ref_thresh: jax.Array


class TrackState(NamedTuple):
    mode: jax.Array  # scalar i32
    T_cw: jax.Array  # (4,4)
    velocity: jax.Array  # (4,4)
    last: FrameFeatures
    last_lms: jax.Array  # (N,3)
    last_lms_valid: jax.Array  # (N,)
    ring_feats: FrameFeatures  # arrays with leading (RING,)
    ring_mpid: jax.Array  # (RING,N)
    ring_T: jax.Array  # (RING,4,4)
    ring_info: jax.Array  # (RING, INFO_DIM) packed per-frame outcomes
    frame_idx: jax.Array  # scalar i32
    since_reloc: jax.Array  # scalar i32: frames since last relocalization
    # Found/visible accumulators, indexed by TRACKING-SET ROW (valid
    # until the host refreshes the set; folded into the map just before
    # each refresh).  Feeds the 0.25 found-ratio map-point cull
    # (localMapping.cpp:90-108; increaseVisible tracking.cpp:570-604).
    vis_acc: jax.Array  # (P,) i32
    found_acc: jax.Array  # (P,) i32


INFO_DIM = 21  # [mode, ok, n_inliers, need_kf, slot, T_cw(16)]


class FrameInfo(NamedTuple):
    """Host-side view of one packed info row."""

    mode: int
    ok: bool
    n_inliers: int
    need_kf: bool
    ring_slot: int
    T_cw: np.ndarray

    @staticmethod
    def unpack(row: np.ndarray) -> "FrameInfo":
        return FrameInfo(
            mode=int(row[0]),
            ok=bool(row[1] > 0.5),
            n_inliers=int(row[2]),
            need_kf=bool(row[3] > 0.5),
            ring_slot=int(row[4]),
            T_cw=row[5:21].reshape(4, 4).astype(np.float64),
        )


def empty_track_state(n: int, n_track_pts: int = 8192) -> TrackState:
    from ..ops.extractor import empty_features

    ef = empty_features(n)
    ring = jax.tree.map(lambda a: jnp.stack([a] * RING), ef)
    return TrackState(
        mode=jnp.int32(MODE_INIT),
        T_cw=jnp.eye(4),
        velocity=jnp.eye(4),
        last=ef,
        last_lms=jnp.zeros((n, 3)),
        last_lms_valid=jnp.zeros((n,), bool),
        ring_feats=ring,
        ring_mpid=-jnp.ones((RING, n), jnp.int32),
        ring_T=jnp.stack([jnp.eye(4)] * RING),
        ring_info=jnp.zeros((RING, INFO_DIM)),
        frame_idx=jnp.int32(0),
        since_reloc=jnp.int32(1 << 20),
        vis_acc=jnp.zeros((n_track_pts,), jnp.int32),
        found_acc=jnp.zeros((n_track_pts,), jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_features", "capacity", "n_levels", "scale_factor",
        "th_high", "th_low", "min_motion", "min_local", "min_init",
        "min_after_reloc", "fps",
        "close_tracked_max", "close_untracked_min", "loc_mode", "subpixel",
    ),
    donate_argnums=(0,),
)
def rgbd_frame_step(
    state: TrackState,
    gray: jax.Array,
    depth: jax.Array,
    trkset: TrackSet,
    cam: CameraIntrinsics,
    inv_sigma2_tab: jax.Array,
    depth_threshold: jax.Array,
    n_features: int = 1000,
    capacity: int = 1024,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: int = 20,
    th_low: int = 7,
    min_motion: int = 10,
    min_local: int = 30,
    min_init: int = 500,
    min_after_reloc: int = 50,
    fps: int = 30,
    close_tracked_max: int = 100,
    close_untracked_min: int = 70,
    loc_mode: bool = False,
    depth_scale=1.0,
    subpixel: bool = True,
):
    """One full RGB-D tracking step on device. Returns state' (the packed
    per-frame outcome lands in state.ring_info — fetched in batches).

    ``gray`` may be uint8 and ``depth`` uint16 (the sensor-native TUM
    encodings, with ``depth_scale`` = 1/DepthMapFactor); both convert on
    device, cutting per-frame host->device transfer 4x vs float32."""
    feats = extract_orb(
        gray, cam, n_features=n_features, capacity=capacity,
        n_levels=n_levels, scale_factor=scale_factor,
        th_high=th_high, th_low=th_low, has_distortion=False,
        subpixel=subpixel,
    )
    depth = depth.astype(jnp.float32) * depth_scale
    feats = fill_depth_from_rgbd(feats, depth, cam)
    return _track_core(
        state, feats, trkset, cam, inv_sigma2_tab, depth_threshold,
        n_levels, scale_factor, min_motion, min_local, min_init,
        min_after_reloc, fps,
        close_tracked_max, close_untracked_min, loc_mode,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_features", "capacity", "n_levels", "scale_factor",
        "th_high", "th_low", "min_motion", "min_local", "min_init",
        "min_after_reloc", "fps",
        "close_tracked_max", "close_untracked_min", "loc_mode", "subpixel",
    ),
    donate_argnums=(0,),
)
def stereo_frame_step(
    state: TrackState,
    gray_l: jax.Array,
    gray_r: jax.Array,
    trkset: TrackSet,
    cam: CameraIntrinsics,
    inv_sigma2_tab: jax.Array,
    depth_threshold: jax.Array,
    n_features: int = 1000,
    capacity: int = 1024,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: int = 20,
    th_low: int = 7,
    min_motion: int = 10,
    min_local: int = 30,
    min_init: int = 500,
    min_after_reloc: int = 50,
    fps: int = 30,
    close_tracked_max: int = 100,
    close_untracked_min: int = 70,
    loc_mode: bool = False,
    subpixel: bool = True,
):
    """One full STEREO tracking step on device: dual extraction +
    row-band stereo association + the shared tracking core."""
    from ..ops.pyramid import build_pyramid
    from ..ops.stereo import stereo_match

    fl = extract_orb(
        gray_l, cam, n_features=n_features, capacity=capacity,
        n_levels=n_levels, scale_factor=scale_factor,
        th_high=th_high, th_low=th_low, has_distortion=False,
        subpixel=subpixel,
    )
    fr = extract_orb(
        gray_r, cam, n_features=n_features, capacity=capacity,
        n_levels=n_levels, scale_factor=scale_factor,
        th_high=th_high, th_low=th_low, has_distortion=False,
        subpixel=subpixel,
    )
    pl_ = build_pyramid(gray_l, n_levels, scale_factor)
    pr_ = build_pyramid(gray_r, n_levels, scale_factor)
    feats = stereo_match(fl, fr, pl_, pr_, cam, n_levels, scale_factor)
    return _track_core(
        state, feats, trkset, cam, inv_sigma2_tab, depth_threshold,
        n_levels, scale_factor, min_motion, min_local, min_init,
        min_after_reloc, fps,
        close_tracked_max, close_untracked_min, loc_mode,
    )


def _track_core(
    state: TrackState,
    feats: FrameFeatures,
    trkset: TrackSet,
    cam: CameraIntrinsics,
    inv_sigma2_tab: jax.Array,
    depth_threshold: jax.Array,
    n_levels: int,
    scale_factor: float,
    min_motion: int,
    min_local: int,
    min_init: int,
    min_after_reloc: int,
    fps: int,
    close_tracked_max: int,
    close_untracked_min: int,
    loc_mode: bool,
):
    n = feats.valid.shape[0]
    n_depth = jnp.sum(feats.valid & (feats.depth > 0))

    # ---------- branch: initialization ----------
    # > 500 depth keypoints required, tracking.cpp:337
    can_init = (state.mode == MODE_INIT) & (n_depth >= min_init)

    # ---------- branch: motion-model tracking ----------
    T_pred = state.velocity @ state.T_cw
    assign7, assign14 = match_motion_model_two(
        cam, feats, state.last, state.last_lms, state.last_lms_valid,
        T_pred, state.T_cw, th_narrow=7.0, th_wide=14.0,
        n_levels=n_levels, scale_factor=scale_factor,
    )
    use_wide = jnp.sum(assign7 >= 0) < 20
    assign = jnp.where(use_wide, assign14, assign7)
    # ---------- fallback: reference-frame appearance matching ----------
    # The reference falls back from motion-model failure (< 20 window
    # matches even widened, tracking.cpp:456-466) to a BoW match against
    # the reference keyframe + pose LM from the unpredicted pose
    # (trackReferenceKeyFrame, tracking.cpp:375-406).  Device analog: a
    # dense appearance match against the LAST tracked frame's landmark
    # set.  The failure decision is made on MATCH COUNTS (the reference's
    # own pre-LM gate), so one shared pose LM serves both branches — its
    # observations and initial pose are selected per branch.  (The
    # post-LM <10-inlier fallback path a second, lax.cond-deferred LM
    # would add is rare enough to leave to relocalization, as
    # documented here.)
    motion_viable = jnp.sum(assign >= 0) >= 20
    fb_assign, _ = match_dense(
        state.last.desc, state.last.valid & state.last_lms_valid,
        state.last.angle,
        feats.desc, feats.valid, feats.angle,
        max_dist=50, ratio=0.7,  # TH_LOW + refKF nn-ratio (tracking.cpp:380)
    )
    fb_viable = (~motion_viable) & (jnp.sum(fb_assign >= 0) >= 15)
    use_assign = jnp.where(motion_viable, assign, fb_assign)
    T_init = jnp.where(motion_viable, T_pred, state.T_cw)
    src = jnp.clip(use_assign, 0, n - 1)
    po = PoseObservations(
        p_w=state.last_lms[src],
        obs_uvr=jnp.concatenate([feats.uv, feats.right_u[:, None]], -1),
        inv_sigma2=inv_sigma2_tab[feats.octave],
        has_stereo=feats.right_u >= 0,
        valid=(use_assign >= 0) & feats.valid & state.last_lms_valid[src]
        & (motion_viable | fb_viable),
    )
    T_frame, _, n_frame = optimize_pose(cam, T_init, po)
    frame_ok = (motion_viable | fb_viable) & (n_frame >= min_motion)

    # ---------- local-map tracking ----------
    T_start = jnp.where(frame_ok, T_frame, T_pred)
    lassign, _, frustum_ok = match_local_points(
        cam, feats, T_start, trkset.pos, trkset.desc, trkset.normal,
        trkset.dmax, trkset.dmin, trkset.valid,
        th=1.0, n_levels=n_levels, scale_factor=scale_factor,
        return_visible=True,
    )
    P = trkset.pos.shape[0]
    lsrc = jnp.clip(lassign, 0, P - 1)
    plo = PoseObservations(
        p_w=trkset.pos[lsrc],
        obs_uvr=jnp.concatenate([feats.uv, feats.right_u[:, None]], -1),
        inv_sigma2=inv_sigma2_tab[feats.octave],
        has_stereo=feats.right_u >= 0,
        valid=(lassign >= 0) & feats.valid & trkset.valid[lsrc],
    )
    T_loc, linlier, n_loc = optimize_pose(cam, T_start, plo)
    # Bootstrap guard: frames dispatched between map initialization and
    # the host's first tracking-set refresh see an (almost) empty
    # trkset; fall back to motion-only tracking rather than declaring
    # LOST (the synchronous reference never hits this because its hook
    # is in-line).
    trk_populated = jnp.sum(trkset.valid) >= min_local
    # Stricter gate within 1 s (= fps frames) of a relocalization
    # (tracking.cpp:630-636: 50 instead of 30 local-map inliers).
    min_local_eff = jnp.where(
        state.since_reloc < jnp.int32(fps), min_after_reloc, min_local
    )
    local_ok = jnp.where(trk_populated, n_loc >= min_local_eff, frame_ok)
    T_loc = jnp.where(trk_populated, T_loc, T_start)
    n_loc = jnp.where(trk_populated, n_loc, n_frame)
    if loc_mode:
        # Localization-only visual odometry (tracking.cpp:407-441): when
        # the frozen map yields too few inliers, keep the motion-model
        # pose and survive on depth-seeded last-frame landmarks instead
        # of going LOST.  Map tracking resumes as soon as enough frozen
        # points re-enter the frustum.
        vo = frame_ok & trk_populated & (n_loc < min_local_eff)
        local_ok = local_ok | vo
        T_loc = jnp.where(vo, T_frame, T_loc)
        n_loc = jnp.where(vo, n_frame, n_loc)

    track_ok = frame_ok & local_ok
    # mpid per keypoint (map-point id) for inlier matches
    mpid = jnp.where(
        trk_populated & linlier & (lassign >= 0), trkset.pts[lsrc], -1
    )

    # ---------- found/visible counters (tracking.cpp:570-604) ----------
    # Visible: the point entered the local search frustum while tracking
    # proceeded (searchLocalPoints' increaseVisible); found: it holds a
    # pose-opt inlier match (increaseFound).  Row-indexed accumulators;
    # the host folds them into the map before each tracking-set refresh.
    count_gate = trk_populated & frame_ok
    vis_rows = (frustum_ok & count_gate).astype(jnp.int32)
    found_kp = (trk_populated & track_ok & linlier & (lassign >= 0))
    found_rows = (
        jnp.zeros_like(state.found_acc)
        .at[jnp.where(found_kp, lassign, state.found_acc.shape[0])]
        .add(1, mode="drop")
    )
    vis_acc = state.vis_acc + vis_rows
    found_acc = state.found_acc + jnp.minimum(found_rows, 1)

    # ---------- keyframe decision counters (tracking.cpp:762-775) ----------
    close = feats.valid & (feats.depth > 0) & (feats.depth <= depth_threshold)
    tracked_close = jnp.sum(close & (mpid >= 0))
    untracked_close = jnp.sum(close & (mpid < 0))
    need_close = (tracked_close < close_tracked_max) & (
        untracked_close > close_untracked_min
    )
    c2 = (n_loc > 15) & (
        (n_loc < trkset.ref_thresh) | need_close
    )
    need_kf = track_ok & c2

    # ---------- select outcome ----------
    T_new = jnp.where(can_init, jnp.eye(4), jnp.where(track_ok, T_loc, state.T_cw))
    ok = can_init | ((state.mode != MODE_INIT) & track_ok)
    new_mode = jnp.where(
        can_init | track_ok, MODE_OK,
        jnp.where(state.mode == MODE_INIT, MODE_INIT, MODE_LOST),
    ).astype(jnp.int32)
    velocity = jnp.where(
        track_ok & (state.mode == MODE_OK),
        T_new @ inv_T(state.T_cw),
        jnp.where(can_init, jnp.eye(4), state.velocity),
    )

    # landmark set for the next frame's motion model: map positions where
    # matched, depth backprojection elsewhere
    p_c = backproject(cam, feats.uv, jnp.maximum(feats.depth, 1e-3))
    R, t = T_new[:3, :3], T_new[:3, 3]
    p_depth = (p_c - t) @ R
    lms = jnp.where((mpid >= 0)[:, None], trkset.pos[lsrc], p_depth)
    lms_valid = (feats.depth > 0) | (mpid >= 0)
    adopt = ok

    def sel(a, b):
        return jnp.where(adopt, a, b)

    new_last = jax.tree.map(
        lambda a, b: jnp.where(
            jnp.reshape(adopt, (1,) * a.ndim), a, b
        ), feats, state.last,
    )
    slot = state.frame_idx % RING
    ring_feats = jax.tree.map(
        lambda ring, f: ring.at[slot].set(f), state.ring_feats, feats
    )
    init_mpid = -jnp.ones((n,), jnp.int32)
    ring_mpid = state.ring_mpid.at[slot].set(jnp.where(can_init, init_mpid, mpid))
    ring_T = state.ring_T.at[slot].set(T_new)

    info_row = jnp.concatenate(
        [
            jnp.stack(
                [
                    new_mode.astype(jnp.float32),
                    ok.astype(jnp.float32),
                    jnp.where(can_init, n_depth, n_loc).astype(jnp.float32),
                    (need_kf | can_init).astype(jnp.float32),
                    slot.astype(jnp.float32),
                ]
            ),
            T_new.reshape(-1),
        ]
    )
    new_state = TrackState(
        mode=new_mode,
        T_cw=T_new,
        velocity=velocity,
        last=new_last,
        last_lms=jnp.where(adopt, lms, state.last_lms),
        last_lms_valid=jnp.where(adopt, lms_valid & feats.valid, state.last_lms_valid),
        ring_feats=ring_feats,
        ring_mpid=ring_mpid,
        ring_T=ring_T,
        ring_info=state.ring_info.at[slot].set(info_row),
        frame_idx=state.frame_idx + 1,
        since_reloc=state.since_reloc + 1,
        vis_acc=vis_acc,
        found_acc=found_acc,
    )
    return new_state


@functools.partial(jax.jit, donate_argnums=(0,))
def fold_track_counters(m, pts, valid, vis_acc, found_acc):
    """Add the device accumulators into MapState.mp_visible/mp_found by
    map-point id (the cull input, localMapping.cpp:90-108).  Called by
    the host immediately BEFORE a tracking-set refresh — the row->id
    mapping dies with the refresh."""
    M = m.mp_found.shape[0]
    idx = jnp.where(valid & (pts >= 0), pts, M)  # out-of-range drops
    return m._replace(
        mp_visible=m.mp_visible.at[idx].add(vis_acc, mode="drop"),
        mp_found=m.mp_found.at[idx].add(found_acc, mode="drop"),
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def clear_track_counters(state: TrackState) -> TrackState:
    return state._replace(
        vis_acc=jnp.zeros_like(state.vis_acc),
        found_acc=jnp.zeros_like(state.found_acc),
    )


@jax.jit
def read_ring(state: TrackState, slot):
    """Gather one ring entry (for keyframe insertion by the host)."""
    feats = jax.tree.map(lambda a: a[slot], state.ring_feats)
    return feats, state.ring_mpid[slot], state.ring_T[slot]
