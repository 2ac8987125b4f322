"""System facade: the full SLAM pipeline behind a 4-call API.

Replaces the reference ``System`` class (src/system.hpp:41-78):
construction from config, ``trackStereo``/``trackRGBD`` frame routing,
localization-only mode, reset, shutdown, and the two TUM trajectory
writers.  Where the reference construction spawns LocalMapping /
LoopClosing / Viewer threads (src/system.cpp:52-61), this system runs
mapping and loop closing synchronously after keyframe insertion — the
pipeline-parallelism decision documented in SURVEY.md §2c P1: on the
device, interleaved threads become batched programs, and the
thread-safety machinery disappears because all state is immutable
arrays.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig, camera_intrinsics
from ..io.trajectory import write_tum_trajectory
from ..ops.extractor import FrameFeatures
from ..ops.pyramid import level_sigma2
from ..optim.pose import PoseObservations, optimize_pose
from .map_state import MapState, empty_map, insert_keyframe
from .mapping import mapping_step  # noqa: F401 (fused per-KF pipeline)
from .matchers import match_local_points
from .tracking import Tracker, TrackingState, landmark_positions

class Sensor(enum.Enum):
    """src/enumclass.hpp:13-17 (monocular unsupported, as in the
    reference: System exits on MONOCULAR, src/system.cpp:73-76)."""

    STEREO = 1
    RGBD = 2


import functools


@functools.partial(jax.jit, static_argnames=("cap", "max_kf"))
def _select_tracking_set(m: MapState, ref_kf, cap: int = 8192, max_kf: int = 80):
    """Local tracking map: points observed by the reference keyframe's
    covisibility neighborhood, capped (tracking.cpp:496-569 builds the
    same set via local-keyframe voting; ``max_kf`` = the reference's cap
    of 80 KFs, tracking.cpp:543).

    SECOND-ORDER expansion (tracking.cpp:544-568): each first-order
    keyframe contributes its strong covisibility neighbors (weight > 10)
    and its spanning-tree parent/children.  First-order keyframes always
    outrank second-order ones, so the expansion only fills slots the
    direct neighborhood leaves free — exactly the reference's
    stop-adding-past-80 behavior.  (Dropped in earlier rounds; restored
    for exploration accuracy — fresh frontier keyframes have few direct
    covisibles, and the second ring holds the points that bridge back.)
    """
    valid_i = m.kf_valid.astype(jnp.int32)
    w = m.covis[ref_kf] * valid_i
    w = w.at[ref_kf].set(1 << 20)
    K1 = min(max_kf, m.K)
    vals, kfs = jax.lax.top_k(w, K1)
    first_ok = vals > 0
    kfc = jnp.clip(kfs, 0, m.K - 1)
    in_first = jnp.zeros((m.K,), bool).at[kfc].max(first_ok, mode="drop")
    # Second ring: strong neighbors of any first-order keyframe...
    rows = m.covis[kfc] * first_ok[:, None]  # (K1, K)
    w2 = jnp.max(jnp.where(rows > 10, rows, 0), axis=0)
    # ...plus spanning-tree parents and children of first-order nodes.
    par = jnp.clip(m.parent[kfc], 0, m.K - 1)
    par_ok = first_ok & (m.parent[kfc] >= 0)
    w2 = w2.at[jnp.where(par_ok, par, m.K)].max(1, mode="drop")
    child_of_first = (m.parent >= 0) & in_first[jnp.clip(m.parent, 0, m.K - 1)]
    w2 = jnp.maximum(w2, child_of_first.astype(jnp.int32))
    w2 = w2 * valid_i * (~in_first)
    # Combined ranking: first-order offset past any second-order weight.
    wc = jnp.where(in_first, w + (1 << 21), w2)
    vals2, kfs2 = jax.lax.top_k(wc, K1)
    sel_kf = jnp.where(vals2 > 0, kfs2, -1)
    in_set = jnp.zeros((m.K + 1,), bool).at[
        jnp.where(sel_kf >= 0, sel_kf, m.K)
    ].set(sel_kf >= 0)[: m.K]
    kf_sel = in_set[:, None] & (m.kf_mp >= 0)
    member = jnp.zeros((m.M,), bool).at[
        jnp.clip(m.kf_mp, 0, m.M - 1)
    ].max(kf_sel, mode="drop")
    member &= m.mp_valid
    order = jnp.where(member, jnp.arange(m.M), m.M)
    pts = jnp.sort(order)[:cap].astype(jnp.int32)
    pts = jnp.where(pts < m.M, pts, -1)
    ptc = jnp.clip(pts, 0, m.M - 1)
    return (
        pts,
        m.mp_pos[ptc],
        m.mp_desc[ptc],
        m.mp_normal[ptc],
        m.mp_max_dist[ptc],
        m.mp_min_dist[ptc],
        (pts >= 0) & m.mp_valid[ptc],
    )


@jax.jit
def _nearest_kf(m: MapState, T_cur: jax.Array) -> jax.Array:
    """Keyframe closest to the current camera in pose space (translation
    + ~2 m-per-radian rotation weight).

    The reference rebuilds its local window EVERY frame by voting with
    the current frame's matches (Tracking::updateLocalKeyFrames,
    tracking.cpp:507-569), so the window follows the camera between
    keyframe insertions.  The pipelined path refreshes per DRAIN
    instead; centering the window on the nearest-pose keyframe is the
    device-cheap equivalent of the vote — and on revisits it snaps the
    window back to the OLD keyframes, re-using the map exactly like the
    reference's vote does."""
    c_cur = -T_cur[:3, :3].T @ T_cur[:3, 3]
    R = m.kf_pose[:, :3, :3]
    t = m.kf_pose[:, :3, 3]
    centers = -jnp.einsum("kij,ki->kj", R, t)  # R^T t per keyframe
    d_t = jnp.linalg.norm(centers - c_cur[None], axis=-1)
    # tr(R_k R_cur^T) = sum_ij R_k[i,j] * R_cur[i,j] -> relative angle.
    tr = jnp.einsum("kij,ij->k", R, T_cur[:3, :3])
    ang = jnp.arccos(jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    cost = jnp.where(m.kf_valid, d_t + 2.0 * ang, jnp.inf)
    return jnp.argmin(cost).astype(jnp.int32)


@jax.jit
def _snapshot_fetch(m: MapState, ref_kf):
    """One fused program for the host snapshot fallback fetch — eager
    ``m.kf_pose[ref]`` indexing would compile throwaway dynamic-slice
    programs mid-sequence."""
    return m.kf_valid, m.parent, m.kf_frame_id, m.kf_pose[ref_kf]


@jax.jit
def _count_ref_tracked(m: MapState, ref_kf, min_obs):
    """KeyFrame::trackedMapPointsNum (keyFrame.cpp:221): reference-KF
    points with >= min_obs observations — the WEIGHTED count (stereo
    obs double, mapPoint.cpp:96-99), so an RGB-D point observed by two
    keyframes passes the min_obs=3 gate exactly as in the reference."""
    ids = jnp.clip(m.kf_mp[ref_kf], 0, m.M - 1)
    live = (m.kf_mp[ref_kf] >= 0) & m.mp_valid[ids]
    obs_live = m.mp_obs_kf[ids] >= 0
    n_obs = jnp.sum(
        jnp.where(obs_live, 1 + m.mp_obs_stereo[ids].astype(jnp.int32), 0),
        axis=-1,
    )
    return jnp.sum(live & (n_obs >= min_obs))


@jax.jit
def _bump_counters(m: MapState, pts, visible, found):
    """MapPoint found/visible counters (mapPoint.hpp accessors), used by
    the 0.25 found-ratio culling rule."""
    ptc = jnp.clip(pts, 0, m.M - 1)
    ok = pts >= 0
    vis = m.mp_visible.at[ptc].add(jnp.where(ok & visible, 1, 0), mode="drop")
    fnd = m.mp_found.at[ptc].add(jnp.where(ok & found, 1, 0), mode="drop")
    return m._replace(mp_visible=vis, mp_found=fnd)


def kf_decision_params(n_keyframes: int, kf_ref_ratio: float):
    """(min_obs, ref_ratio) of the keyframe decision for a map of
    ``n_keyframes`` — the young-map relaxations of tracking.cpp:749-760
    (nKFs <= 2 -> minObs 2; nKFs < 2 -> ratio 0.4).  Single source of
    truth for BOTH the synchronous decision (_need_new_keyframe) and
    the device path's precomputed threshold (_refresh_trkset)."""
    if n_keyframes < 2:
        return 2, 0.4
    if n_keyframes == 2:
        return 2, kf_ref_ratio
    return 3, kf_ref_ratio


@dataclasses.dataclass
class SystemRecord:
    timestamp: float
    ref_kf: int
    T_c_ref: np.ndarray
    lost: bool


class SlamSystem:
    """End-to-end SLAM: tracking + local mapping (+ loop closing when
    enabled via slam/loop.py)."""

    def __init__(
        self,
        cfg: SlamConfig,
        sensor: Sensor = Sensor.RGBD,
        enable_mapping: bool = True,
        enable_loop_closing: bool = True,
    ):
        self.cfg = cfg
        self.sensor = sensor
        self.cam = camera_intrinsics(cfg)
        self.tracker = Tracker(cfg)
        self.enable_mapping = enable_mapping
        self.enable_loop_closing = enable_loop_closing
        # Per-frame outcome trace (diagnosis aid): when the env knob is
        # set, every drained frame appends (timestamp, mode, ok,
        # n_inliers, need_kf, inserted_kf) — the pipelined analog of
        # watching the reference's per-frame tracking log.
        import os as _os

        self.frame_trace = (
            [] if _os.environ.get("YDORBSLAM_TRACE_FRAMES") else None
        )
        cap = cfg.capacity
        self.map = empty_map(
            cap.max_keyframes, cfg.n_keypoints, cap.max_map_points,
            cap.max_obs_per_point,
        )
        self.inv_sigma2_tab = jnp.asarray(
            1.0 / level_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor)
        )
        # depth threshold in meters: ThDepth baselines (tracking.cpp:62)
        self.depth_threshold = cfg.depth.th_depth * cfg.camera.bf / cfg.camera.fx
        self.n_keyframes = 0
        # Device-resident constants for the hot paths: building these
        # eagerly per call would add a tiny transfer (scalars) or a
        # throwaway op compile (the -1 fill) to every frame/keyframe.
        self._depth_thr_dev = jnp.float32(self.depth_threshold)
        self._no_match = jnp.asarray(
            np.full((cfg.n_keypoints,), -1, np.int32)
        )
        self.free_kf_slots: List[int] = []
        self.ref_kf = 0
        self.frame_id = 0
        self.frames_since_kf = 0
        self.records: List[SystemRecord] = []
        self.localization_only = False
        self.visual_odometry = False  # m_b_isDoingVisualOdometry analog
        self.loop_closer = None
        if enable_mapping:
            self.tracker.local_map_hook = self._local_map_hook
            self.tracker.new_kf_hook = self._insert_keyframe
            self.tracker.reloc_hook = self._relocalize
        from .retrieval import empty_index

        self.retrieval = empty_index(cap.max_keyframes, **self._bank_kw)
        if enable_loop_closing and enable_mapping:
            from .loop import LoopCloser

            self.loop_closer = LoopCloser(self)
        self._frame_mpid = None  # (N,) map-point id per current-frame kp
        self.viewer = None  # optional PeriodicViewer (attach_viewer)
        from .stats import RunStats

        self.stats = RunStats()

    def attach_viewer(self, out_dir: str, every: int = 30, **kw):
        """Enable in-run periodic rendering (viewer.cpp:37-121 analog):
        every ``every`` tracked frames write an annotated frame PNG and
        a top-down map PNG under ``out_dir``."""
        from ..viz.headless import PeriodicViewer

        self.viewer = PeriodicViewer(out_dir, every=every, **kw)
        return self.viewer

    def run_stats(self) -> dict:
        """Per-run observability counters (SURVEY.md §5: metrics).

        Merges the live host counters with values derived from the frame
        records plus ONE map fetch — call at sequence end (the apps do),
        not per frame."""
        s = self.stats
        s.frames_total = len(self.records)
        s.frames_lost = sum(1 for r in self.records if r.lost)
        if self.loop_closer is not None:
            s.loops_closed = self.loop_closer.n_loops_closed
        d = s.as_dict()
        # n_keyframes is the insertion counter (it never decrements on
        # culls); live = currently valid slots.
        d["keyframes_live"] = int(np.asarray(self.map.kf_valid).sum())
        d["map_points_live"] = int(np.asarray(self.map.mp_valid).sum())
        return d

    def precompile(self):
        """Compile every steady-state device program up front.

        JAX compiles per argument shape on FIRST call; a compile stalls
        tracking for seconds when it lands mid-sequence (the first
        keyframe cull, the first full-size local BA window...).  This runs each program once on throwaway scratch
        state — the live map/tracker are untouched.  Requires pipelined
        mode (``enable_pipelined`` first).  Rare recovery paths
        (relocalization, loop closing) still compile on first use.
        """
        from .map_state import insert_keyframe as _insert
        from .mapping import SNAP_CULL_CAP, mapping_finish, mapping_prep
        from .pipeline import empty_track_state, read_ring
        from .pipeline import rgbd_frame_step, stereo_frame_step
        from .retrieval import add_keyframe, empty_index, remove_keyframes

        cfg = self.cfg
        cap = cfg.capacity
        o = cfg.orb
        # Host-transferred scratch images: the REAL ingestion path
        # transfers numpy frames, and XLA assigns transferred buffers the
        # default layout — a device-computed scratch (jnp.zeros/.astype)
        # can pick a different layout and silently recompile the whole
        # tracking step at the first real frame.
        shape = (cfg.camera.height, cfg.camera.width)
        img = jnp.asarray(np.zeros(shape, np.float32))
        kw = dict(
            n_features=o.n_features, capacity=cfg.n_keypoints,
            n_levels=o.n_levels, scale_factor=o.scale_factor,
            th_high=o.ini_th_fast, th_low=o.min_th_fast,
            subpixel=o.subpixel,
            min_motion=cfg.tracking.min_matches_motion,
            min_local=cfg.tracking.min_matches_local_map,
            min_init=cfg.tracking.min_init_depth_points,
            min_after_reloc=cfg.tracking.min_matches_after_reloc,
            fps=max(1, int(cfg.camera.fps)),
            close_tracked_max=cfg.tracking.kf_close_tracked_max,
            close_untracked_min=cfg.tracking.kf_close_untracked_min,
            # jit's tracing cache keys on the KWARG SET, not just values:
            # the real calls pass loc_mode explicitly, so precompile must
            # too or the first real frame silently retraces (a
            # multi-second stall).
            loc_mode=self.localization_only,
        )
        st = empty_track_state(cfg.n_keypoints, cap.tracking_points)
        img8 = jnp.asarray(np.zeros(shape, np.uint8))
        img16 = jnp.asarray(np.zeros(shape, np.uint16))
        if self.sensor == Sensor.RGBD:
            # Sensor-native ingestion only (uint8 gray + uint16 depth —
            # what the TUM loader and bench deliver).  A float32 feed
            # still works; its step variant compiles on first use.
            st = rgbd_frame_step(
                st, img8, img16, self._trkset, self.cam,
                self.inv_sigma2_tab, jnp.float32(self.depth_threshold),
                depth_scale=jnp.float32(1.0), **kw,
            )
        else:
            st = stereo_frame_step(
                st, img8, img8, self._trkset, self.cam, self.inv_sigma2_tab,
                jnp.float32(self.depth_threshold), **kw,
            )
        feats, mpid, T = read_ring(st, 0)

        m = jax.tree.map(jnp.copy, self.map)
        m, _ = _insert(
            m, 0, 0, 0.0, feats, T, mpid, self.cam,
            jnp.float32(self.depth_threshold), jnp.int32(0),
            scale_factor=o.scale_factor, n_levels=o.n_levels,
            min_close_seed=self.cfg.tracking.min_close_seed_points,
        )
        m = mapping_prep(
            m, jnp.int32(0), jnp.int32(3), self.cam,
            scale_factor=o.scale_factor, n_levels=o.n_levels,
            **self._prep_kw,
        )
        # Both local-BA capacity buckets (small early-map + full).
        saved = self.n_keyframes
        for nkf in (0, cap.local_ba_window_kf):
            self.n_keyframes = nkf
            win_cap, fix_cap, pts_cap = self._ba_caps()
            m, _ = mapping_finish(
                m, jnp.int32(0), self.cam, self.inv_sigma2_tab,
                jnp.float32(self.depth_threshold),
                iters1=cfg.optim.local_ba_iters_1,
                iters2=cfg.optim.local_ba_iters_2,
                win_cap=win_cap, fix_cap=fix_cap, pts_cap=pts_cap,
                obs_cap=cap.local_ba_obs,
                kf_cull_redundancy=self.cfg.mapping.kf_cull_redundancy,
            )
        self.n_keyframes = saved
        idx = empty_index(cap.max_keyframes, **self._bank_kw)
        idx = add_keyframe(idx, 0, m.kf_desc[0], m.kf_kp_valid[0], **self._bank_kw)
        idx = remove_keyframes(
            idx, jnp.full((SNAP_CULL_CAP,), -1, jnp.int32)
        )
        _select_tracking_set(
            self.map, 0, cap.tracking_points,
            self.cfg.tracking.local_window_max_kf,
        )
        for min_obs in (2, 3):
            _count_ref_tracked(self.map, 0, min_obs)
        _snapshot_fetch(self.map, jnp.int32(0))
        if self.loop_closer is not None:
            # Loop-candidate detection runs on every keyframe once the
            # closer is active; compile it here, not mid-sequence.
            from .loop_impl import _detect_on_device

            C = cap.loop_candidates
            # kf_id as a python int: the real call site passes one, and
            # weak-vs-strong scalar typing is a tracing-cache key.
            _detect_on_device(
                self.map, self.retrieval, 0,
                jnp.zeros((C, self.map.K), bool),
                -jnp.ones((C,), jnp.int32),
                C, cfg.loop.covisibility_consistency_th,
                n_banks=cfg.loop.retrieval_banks,
                bank_bits=cfg.loop.retrieval_bank_bits,
                min_frame_gap=cfg.loop.min_frame_gap,
            )
            # Sim3 verification fires on the FIRST surviving candidate
            # set — mid-sequence, where its compile is a multi-second
            # stall (a bench pass measured 10 s).  Same static kwargs as
            # the LoopCloserImpl._compute_sim3 call site (tracing-cache
            # keys); kf ids as python ints likewise.
            from .loop_impl import _verify_pack

            _, sub = jax.random.split(jax.random.PRNGKey(0))
            _verify_pack(
                self.map, 0, 0, sub, self.cam,
                th_low=cfg.matcher.th_low,
                ratio=cfg.matcher.ratio_reloc,
                n_hypotheses=cfg.loop.ransac_max_iters,
                min_inliers=cfg.loop.ransac_min_inliers,
                sim3_iters=cfg.optim.sim3_iters,
                scale_factor=cfg.orb.scale_factor,
                n_levels=cfg.orb.n_levels,
                guided_cap=cfg.capacity.tracking_points,
            )
            # The correction program (group Sim3 + bind + whole-group
            # fuse + covis rebuild) fires exactly at the closure frame
            # — compiling it there would put a multi-second stall on
            # the one frame whose latency the loop design protects.
            from .loop_impl import _correct_on_device

            _correct_on_device(
                self.map, 0, 0, jnp.eye(4),
                -jnp.ones((self.map.N,), jnp.int32), self.cam,
                scale_factor=cfg.orb.scale_factor,
                n_levels=cfg.orb.n_levels,
                fuse_pts_cap=cfg.capacity.loop_fuse_points,
                fuse_group_cap=cfg.capacity.loop_fuse_group,
            )
        jax.block_until_ready(m)

    # ------------------------------------------------------------------
    # host graph snapshot: ONE bulk device->host fetch per refresh.
    # Each individual np.asarray read synchronizes with the device;
    # everything host-side control flow needs (slot allocation, neighbor
    # selection, record rebasing, trajectory caching) reads this
    # snapshot instead.
    # ------------------------------------------------------------------
    def _refresh_snapshot(self):
        """Synchronous fallback fetch (init/reset paths).  The steady
        state never calls this: mapping_step returns a PACKED snapshot
        vector that is copied host-ward asynchronously and consumed a
        few frames later (one vector, so one device->host read)."""
        got = jax.device_get(
            _snapshot_fetch(self.map, jnp.int32(self.ref_kf))
        )
        self._snap = {
            "kf_valid": got[0].copy(),
            "parent": got[1],
            "kf_frame_id": got[2],
            "ref_pose": got[3].astype(np.float64),
        }
        return self._snap

    def _stash_snapshot(self, snap_vec):
        """Register mapping_step's packed snapshot and start its async
        device->host copy; `_snapshot()` consumes it lazily."""
        try:
            snap_vec.copy_to_host_async()
        except Exception:
            pass  # backends without async copy still work (sync read later)
        self._pending_snap = snap_vec

    def _consume_pending_snapshot(self):
        from .mapping import SNAP_CULL_CAP, snapshot_layout

        vec = self._pending_snap
        self._pending_snap = None
        v = np.asarray(vec)
        K = self.map.K
        off, _ = snapshot_layout(K)

        def seg(name):
            a, b = off[name]
            return v[a:b]

        self._snap = {
            "kf_valid": seg("kf_valid") > 0.5,
            "parent": seg("parent").astype(np.int64),
            "kf_frame_id": seg("kf_frame_id").astype(np.int64),
            "ref_pose": seg("ref_pose").reshape(4, 4).astype(np.float64),
        }
        culled_ids = seg("culled_ids").astype(np.int64)
        culled = [int(k) for k in culled_ids if k >= 0]
        if culled:
            c2p = seg("culled_c2p").reshape(SNAP_CULL_CAP, 4, 4).astype(np.float64)
            T_c2p = {int(k): c2p[i] for i, k in enumerate(culled_ids) if k >= 0}
            self._rebase_records(culled, T_c2p, self._snap["parent"])
        return self._snap

    def _snapshot(self):
        if getattr(self, "_pending_snap", None) is not None:
            return self._consume_pending_snapshot()
        if getattr(self, "_snap", None) is None:
            self._refresh_snapshot()
        return self._snap

    # ------------------------------------------------------------------
    # public API (mirrors src/system.hpp)
    # ------------------------------------------------------------------
    def track_rgbd(self, timestamp, gray, depth) -> bool:
        assert self.sensor == Sensor.RGBD, "sensor mismatch (system.cpp:112-115)"
        ok = self.tracker.track_rgbd(timestamp, gray, depth)
        self._record(timestamp, ok)
        if self.viewer is not None:
            self.viewer.maybe_draw(self, self.frame_id, gray)
        self.frame_id += 1
        return ok

    def track_stereo(self, timestamp, gray_l, gray_r) -> bool:
        assert self.sensor == Sensor.STEREO, "sensor mismatch (system.cpp:73-76)"
        ok = self.tracker.track_stereo(timestamp, gray_l, gray_r)
        self._record(timestamp, ok)
        if self.viewer is not None:
            self.viewer.maybe_draw(self, self.frame_id, gray_l)
        self.frame_id += 1
        return ok

    def activate_localization_mode(self):
        """Pause mapping; keep tracking (system.cpp:80-87).  Tracking
        falls back to visual odometry (motion model over depth-seeded
        last-frame landmarks) whenever the frozen map leaves the frustum
        (tracking.cpp:407-441)."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.visual_odometry = False

    def reset(self):
        """Clear map + tracker state (system.cpp:96-102, tracking.cpp:150-180)."""
        cap = self.cfg.capacity
        self.map = empty_map(
            cap.max_keyframes, self.cfg.n_keypoints, cap.max_map_points,
            cap.max_obs_per_point,
        )
        self.tracker = Tracker(self.cfg)
        if self.enable_mapping:
            self.tracker.local_map_hook = self._local_map_hook
            self.tracker.new_kf_hook = self._insert_keyframe
            self.tracker.reloc_hook = self._relocalize
        from .retrieval import empty_index

        self.retrieval = empty_index(cap.max_keyframes, **self._bank_kw)
        if self.loop_closer is not None:
            from .loop import LoopCloser

            self.loop_closer = LoopCloser(self)
        self.n_keyframes = 0
        self.free_kf_slots = []
        self.ref_kf = 0
        self.frames_since_kf = 0
        self.records = []
        self._pending_snap = None
        self._snap = None
        # Fresh counter epoch: run_stats() recomputes frame-derived
        # fields from the (now cleared) records, so carrying pre-reset
        # inlier/keyframe counters would mix epochs (inlier_frames could
        # exceed frames_total).  Only the reset count itself survives.
        from .stats import RunStats

        resets = self.stats.resets + 1
        self.stats = RunStats()
        self.stats.resets = resets

    def shutdown(self):
        """Drain the pipelined queue; no threads to join
        (system.cpp:176-191 parity)."""
        if getattr(self, "_pending", None):
            self.flush_pipeline()
        if self.loop_closer is not None:
            self.loop_closer.flush()

    def update_calibration(self, yaml_path: str):
        """Runtime re-calibration from a settings YAML
        (Tracking::changeIntParMat, tracking.cpp:128-146)."""
        import dataclasses

        from ..config import camera_intrinsics, load_config

        self.cfg = load_config(yaml_path, base=self.cfg)
        self.cam = camera_intrinsics(self.cfg)
        self.tracker.cam = self.cam
        self.depth_threshold = (
            self.cfg.depth.th_depth * self.cfg.camera.bf / self.cfg.camera.fx
        )
        self._depth_thr_dev = jnp.float32(self.depth_threshold)

    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def tracked_map_points(self) -> int:
        """System::getTrackedMapPoints analog (system.hpp:74-77)."""
        return self.tracker.n_inliers

    def tracked_keypoints(self):
        """System::getTrackedKeyPoints analog: the last frame's keypoint
        coordinates + validity."""
        f = self.tracker.last_feats
        if f is None:
            return None
        return np.asarray(f.uv), np.asarray(f.valid)

    def map_changed_index(self) -> int:
        """Big-change counter analog (map.hpp:46-47)."""
        return self.n_keyframes

    # ------------------------------------------------------------------
    # pipelined (device-resident) tracking — the fast path
    # ------------------------------------------------------------------
    def enable_pipelined(self, lag: int = 3):
        """Switch to the zero-sync-per-frame pipelined tracker
        (slam/pipeline.py).  Host decisions (keyframes, records, reloc)
        are made ``lag`` frames late from asynchronously fetched
        FrameInfo — the dispatch-ahead equivalent of the reference's
        LocalMapping queue."""
        from .pipeline import TrackSet, empty_track_state

        self._pipe_lag = lag
        # Wall-time budget accounting (bench.py --profile reads this):
        # where the HOST spends its time per drained batch.  The ring
        # fetch blocks until the device catches up, so "drain_fetch" is
        # device-backlog + transfer; the rest are host dispatch/python.
        import collections

        self.perf = collections.defaultdict(float)
        self._trkset = None
        self._dstate = empty_track_state(
            self.cfg.n_keypoints, self.cfg.capacity.tracking_points
        )
        self._pending = []
        self._pipe_frames_since_kf = 0
        self._inlier_peak = 0.0  # stress-gate yardstick (see _drain_batch)
        self._stress_drains = 0
        self._refresh_trkset()

    @property
    def _effective_lag(self) -> int:
        """Per-frame drain while the map bootstraps, full lag afterwards.

        Frames dispatched between map initialization and the first
        tracking-set refresh would otherwise track motion-only against a
        stale empty set; each keyframe inserted from them re-seeds the
        SAME landmarks as unlinked duplicates, and duplicated points then
        kill the best/second-best ratio test in local matching (two
        near-identical candidates -> ratio ~1 -> no match) until
        tracking collapses.  The reference never hits this because its
        mapping hook is synchronous (tracking.cpp:839).  Drain every
        frame until the map initializes, then at short lag until a few
        properly-associated keyframes exist; the steady state then runs
        at full lag."""
        if self.n_keyframes == 0:
            return 1
        if self.n_keyframes < 3 and self.frame_id < 24:
            # Stale-dispatch duplicates only arise while the FIRST few
            # keyframes are being minted from frames that predate the
            # tracking set (later keyframes fuse against an
            # already-populated map, and mapping_prep's fusion pass
            # merges the remainder).  A sparse scene that simply doesn't
            # need a 3rd keyframe must not pin the pipeline at short lag.
            return min(3, self._pipe_lag)
        if getattr(self, "_stress_drains", 0) > 0:
            # TRACKING STRESS: the last drain saw a lost frame or an
            # inlier count collapsing below 0.6x its healthy level.  On
            # workloads with steadily-shrinking view overlap (constant
            # angular velocity), the batched keyframe decision arrives
            # up to ``lag`` frames late — past the overlap cliff the
            # synchronous reference never falls off (its insertion hook
            # is in-line, tracking.cpp:839).  Shrinking the batch bounds
            # the decision latency exactly while the margin is thin;
            # steady healthy tracking keeps the full-throughput lag.
            return min(3, self._pipe_lag)
        return self._pipe_lag

    def _refresh_trkset(self, T_latest=None):
        """Rebuild the device tracking set.

        ``T_latest`` (the newest drained OK pose) centers the window on
        the nearest-pose keyframe instead of the newest one — the
        per-drain analog of the reference's per-frame local-window vote
        (tracking.cpp:507-569); without it a constant-rate rotation
        walks out of the window pinned at the last insertion."""
        from .pipeline import (TrackSet, clear_track_counters,
                               fold_track_counters)

        cap = self.cfg.capacity.tracking_points
        # Fold the device found/visible accumulators into the map FIRST:
        # they are indexed by rows of the OUTGOING tracking set.
        if getattr(self, "_trkset", None) is not None and getattr(
            self, "_dstate", None
        ) is not None:
            self.map = fold_track_counters(
                self.map, self._trkset.pts, self._trkset.valid,
                self._dstate.vis_acc, self._dstate.found_acc,
            )
            self._dstate = clear_track_counters(self._dstate)
        if T_latest is not None and self.n_keyframes > 1:
            window_ref = _nearest_kf(self.map, jnp.asarray(T_latest, jnp.float32))
        else:
            window_ref = jnp.int32(self.ref_kf)
        pts, pos, desc, normal, dmax, dmin, valid = _select_tracking_set(
            self.map, window_ref, cap,
            self.cfg.tracking.local_window_max_kf,
        )
        min_obs, ref_ratio = kf_decision_params(
            self.n_keyframes, self.cfg.tracking.kf_ref_ratio
        )
        ref_tracked = _count_ref_tracked(self.map, window_ref, min_obs)
        self._trkset = TrackSet(
            pts=pts, pos=pos, desc=desc, normal=normal, dmax=dmax,
            dmin=dmin, valid=valid,
            ref_thresh=ref_tracked.astype(jnp.float32) * ref_ratio,
        )
        self._inlier_peak = 0.0  # stress yardstick restarts per window

    def track_rgbd_pipelined(self, timestamp, gray, depth) -> None:
        """Dispatch one frame; decisions drain in BATCHES.

        The packed outcomes of several frames are fetched in one small
        device->host read, so steady-state tracking synchronizes with
        the device ~1/lag times per frame.  Call
        ``flush_pipeline()`` at sequence end (shutdown does)."""
        from .pipeline import rgbd_frame_step

        cfg = self.cfg
        o = cfg.orb
        # Sensor-native ingestion: uint8 gray / uint16 raw depth ship as
        # is (4x less host->device traffic than float32); conversion and
        # DepthMapFactor scaling happen inside the jitted step.
        depth = np.asarray(depth)
        scale = (
            1.0 / cfg.depth.depth_map_factor
            if depth.dtype == np.uint16 else 1.0
        )
        self._dstate = rgbd_frame_step(
            self._dstate,
            jnp.asarray(gray), jnp.asarray(depth),
            self._trkset, self.cam, self.inv_sigma2_tab,
            self._depth_thr_dev,
            depth_scale=jnp.float32(scale),
            n_features=o.n_features, capacity=cfg.n_keypoints,
            n_levels=o.n_levels, scale_factor=o.scale_factor,
            th_high=o.ini_th_fast, th_low=o.min_th_fast,
            subpixel=o.subpixel,
            min_motion=cfg.tracking.min_matches_motion,
            min_local=cfg.tracking.min_matches_local_map,
            min_init=cfg.tracking.min_init_depth_points,
            min_after_reloc=cfg.tracking.min_matches_after_reloc,
            fps=max(1, int(cfg.camera.fps)),
            close_tracked_max=cfg.tracking.kf_close_tracked_max,
            close_untracked_min=cfg.tracking.kf_close_untracked_min,
            loc_mode=self.localization_only,
        )
        self._pending.append((timestamp, self.frame_id))
        if self.viewer is not None:
            # Frame annotation is lag frames stale in pipelined mode
            # (features are device-resident); the map view is current.
            self.viewer.maybe_draw(self, self.frame_id, None)
        self.frame_id += 1
        if len(self._pending) >= self._effective_lag:
            self._drain_batch()

    def track_stereo_pipelined(self, timestamp, gray_l, gray_r) -> None:
        """Stereo analog of track_rgbd_pipelined."""
        from .pipeline import stereo_frame_step

        cfg = self.cfg
        o = cfg.orb
        self._dstate = stereo_frame_step(
            self._dstate,
            jnp.asarray(gray_l), jnp.asarray(gray_r),
            self._trkset, self.cam, self.inv_sigma2_tab,
            self._depth_thr_dev,
            n_features=o.n_features, capacity=cfg.n_keypoints,
            n_levels=o.n_levels, scale_factor=o.scale_factor,
            th_high=o.ini_th_fast, th_low=o.min_th_fast,
            subpixel=o.subpixel,
            min_motion=cfg.tracking.min_matches_motion,
            min_local=cfg.tracking.min_matches_local_map,
            min_init=cfg.tracking.min_init_depth_points,
            min_after_reloc=cfg.tracking.min_matches_after_reloc,
            fps=max(1, int(cfg.camera.fps)),
            close_tracked_max=cfg.tracking.kf_close_tracked_max,
            close_untracked_min=cfg.tracking.kf_close_untracked_min,
            loc_mode=self.localization_only,
        )
        self._pending.append((timestamp, self.frame_id))
        if self.viewer is not None:
            # Frame annotation is lag frames stale in pipelined mode
            # (features are device-resident); the map view is current.
            self.viewer.maybe_draw(self, self.frame_id, None)
        self.frame_id += 1
        if len(self._pending) >= self._effective_lag:
            self._drain_batch()

    def flush_pipeline(self):
        while getattr(self, "_pending", None):
            self._drain_batch()

    def _drain_batch(self):
        """Fetch the info ring once; process every pending frame.

        Keyframes inserted while draining run only the per-keyframe
        mapping half (triangulate/fuse); the local BA + keyframe-culling
        half runs ONCE at the end of the batch on the newest keyframe —
        the reference's ``interruptBA`` semantics (localMapping.cpp:54-58:
        a queued keyframe force-stops the running local BA, so only the
        last keyframe of a burst gets a full BA)."""
        from .pipeline import RING, FrameInfo

        if not self._pending:
            return
        assert len(self._pending) <= RING, "pipeline lag exceeds ring size"
        _t0 = time.perf_counter()
        ring = np.asarray(self._dstate.ring_info)  # ONE small fetch
        self.perf["drain_fetch"] += time.perf_counter() - _t0
        _t0 = time.perf_counter()
        # Fold the found/visible accumulators EVERY batch (not only at
        # tracking-set refreshes): the 0.25 found-ratio cull checks each
        # recent point inside a ~3-keyframe age window, and the
        # reference bumps these counters synchronously every frame
        # (tracking.cpp:570-604) — folding only at refresh delivered the
        # counts after the window had already closed.
        from .pipeline import clear_track_counters, fold_track_counters

        if self._trkset is not None:
            self.map = fold_track_counters(
                self.map, self._trkset.pts, self._trkset.valid,
                self._dstate.vis_acc, self._dstate.found_acc,
            )
            self._dstate = clear_track_counters(self._dstate)
        batch = self._pending
        self._pending = []
        self._batch_inserted = False
        self._ba_pending = False
        infos = [FrameInfo.unpack(ring[fid % RING]) for _, fid in batch]
        # Stress gate for the adaptive drain lag (see _effective_lag):
        # a lost frame, or the inlier count falling below HALF its peak
        # since the last window refresh, arms short-lag draining.  The
        # peak (not a running mean) is the right yardstick: on a
        # steadily-shrinking-overlap workload a smoothed level tracks
        # the decay itself and never alarms before the cliff.
        ok_inl = [i.n_inliers for i in infos if i.ok]
        peak = getattr(self, "_inlier_peak", 0.0)
        stress = self.cfg.tracking.stress_lag and (
            any(not i.ok for i in infos)
            or (bool(ok_inl) and peak > 0 and min(ok_inl) < 0.5 * peak)
        )
        if ok_inl:
            self._inlier_peak = max(peak, max(ok_inl))
        self._stress_drains = 3 if stress else max(0, self._stress_drains - 1)
        for i, (timestamp, fid) in enumerate(batch):
            info = infos[i]
            # Relocalize at most ONCE per batch, from the NEWEST frame:
            # earlier LOST frames in the batch are history by drain time
            # (the reference relocalizes the *current* frame,
            # tracking.cpp:257-259); attempting a synchronous reloc per
            # stale frame serializes host<->device synchronizations.
            self._drain_one(
                timestamp, info, allow_reloc=(i == len(batch) - 1)
            )
        self.perf["drain_frames"] += time.perf_counter() - _t0
        _t0 = time.perf_counter()
        if self._ba_pending:
            self._run_deferred_ba()
        self.perf["deferred_ba"] += time.perf_counter() - _t0
        # Refresh the tracking window at keyframe insertions, centered
        # on the keyframe nearest the newest drained pose (the per-drain
        # analog of the reference's per-frame local-window vote,
        # tracking.cpp:507-569 — after a relocalization or loop the
        # nearest keyframe is an OLD one and the window snaps back to
        # the revisited map).  Refreshing on EVERY drain was measured to
        # degrade exploration accuracy (the mid-window threshold and
        # counter-fold churn outweigh the freshness), so between
        # insertions the window stays pinned.
        T_latest = None
        for info in reversed(infos):
            if info.ok:
                T_latest = info.T_cw
                break
        _t0 = time.perf_counter()
        if self._batch_inserted:
            self._refresh_trkset(T_latest)
        self.perf["trkset_refresh"] += time.perf_counter() - _t0
        _t0 = time.perf_counter()
        if self.loop_closer is not None:
            # One global-BA LM chunk per drained batch: in-flight loop
            # BAs overlap tracking instead of stalling it (the
            # reference's transient BA thread, loopClosing.cpp:334).
            self.loop_closer.tick()
        self.perf["loop_tick"] += time.perf_counter() - _t0


    @property
    def _bank_kw(self):
        return dict(
            n_banks=self.cfg.loop.retrieval_banks,
            bank_bits=self.cfg.loop.retrieval_bank_bits,
        )

    @property
    def _prep_kw(self):
        mc = self.cfg.mapping
        return dict(
            n_neighbors=mc.triangulation_neighbors,
            cull_found_ratio=mc.cull_found_ratio,
            cull_min_obs=mc.cull_min_obs,
            tri_ratio=self.cfg.matcher.ratio_triangulation,
        )
    def _ba_caps(self):
        """Static local-BA capacity bucket for the current map size.

        A young map never fills the full BA window, and local-BA cost
        scales with win*pts*obs.  Two compiled sizes (small for the
        first keyframes, full afterwards) keep the early sequence fast
        without touching behavior — the small caps still exceed the
        actual map content."""
        cap = self.cfg.capacity
        if self.n_keyframes <= min(20, cap.local_ba_window_kf // 2):
            return (
                max(4, cap.local_ba_window_kf // 2),
                max(2, cap.local_ba_fixed_kf // 2),
                max(256, cap.local_ba_max_points // 2),
            )
        return (
            cap.local_ba_window_kf,
            cap.local_ba_fixed_kf,
            cap.local_ba_max_points,
        )

    def _run_deferred_ba(self):
        """Batch-deferred local BA + keyframe culling on the newest KF."""
        from .mapping import mapping_finish

        cfg = self.cfg
        win_cap, fix_cap, pts_cap = self._ba_caps()
        self.map, snap_vec = mapping_finish(
            self.map, jnp.int32(self.ref_kf), self.cam,
            self.inv_sigma2_tab, self._depth_thr_dev,
            iters1=cfg.optim.local_ba_iters_1,
            iters2=cfg.optim.local_ba_iters_2,
            win_cap=win_cap, fix_cap=fix_cap, pts_cap=pts_cap,
            obs_cap=cfg.capacity.local_ba_obs,
            kf_cull_redundancy=cfg.mapping.kf_cull_redundancy,
        )
        self._ba_pending = False
        self.stats.local_ba_runs += 1
        self._stash_snapshot(snap_vec)

    def _drain_one(self, timestamp, info, allow_reloc: bool = True):
        from .pipeline import MODE_LOST, read_ring

        ok = info.ok
        mode = info.mode
        self._pipe_frames_since_kf += 1
        T_cw = info.T_cw
        if ok:
            T_ref = self._snapshot()["ref_pose"]
            self.records.append(
                SystemRecord(
                    timestamp, self.ref_kf, T_cw @ np.linalg.inv(T_ref), False
                )
            )
        else:
            self.records.append(
                SystemRecord(timestamp, self.ref_kf, np.eye(4), True)
            )
        self.tracker.n_inliers = int(info.n_inliers)
        if ok:
            self.stats.inlier_sum += self.tracker.n_inliers
            self.stats.inlier_frames += 1
        self.tracker.state = (
            TrackingState.OK if ok else (
                TrackingState.LOST if mode == MODE_LOST
                else TrackingState.NOT_INITIALIZED
            )
        )
        if self.frame_trace is not None:
            self.frame_trace.append(
                (timestamp, int(mode), bool(ok), int(info.n_inliers),
                 bool(info.need_kf), False)
            )
        if mode == MODE_LOST:
            if allow_reloc:
                self._pipelined_relocalize(timestamp, int(info.ring_slot))
            return
        if bool(info.need_kf) and ok and not self.localization_only:
            first = self.n_keyframes == 0
            # Backpressure: the reference drops keyframe requests when
            # the mapping queue holds >= 3 frames (tracking.cpp:787-791);
            # the synchronous-mapping analog is a minimum spacing of 2
            # tracked frames between insertions.
            if first or self._pipe_frames_since_kf >= 2:
                feats, mpid, T = read_ring(self._dstate, int(info.ring_slot))
                self._insert_keyframe(
                    timestamp, feats, T, matched_mp=None if first else mpid,
                    defer_ba=True, T_host=info.T_cw,
                )
                self._pipe_frames_since_kf = 0
                self._batch_inserted = True
                if self.frame_trace is not None:
                    self.frame_trace[-1] = self.frame_trace[-1][:5] + (True,)

    def _pipelined_relocalize(self, timestamp, slot):
        """Synchronous relocalization from a ring frame; on success the
        device state is reset to the recovered pose."""
        from .pipeline import MODE_OK, read_ring
        from .tracking import landmark_positions

        if self.n_keyframes < 2:
            return  # nothing meaningful to relocalize against yet
        feats, _, _ = read_ring(self._dstate, slot)
        if not self._relocalize(self.tracker, timestamp, feats):
            return
        T = self.tracker.T_cw
        lms, lms_valid = landmark_positions(self.cam, feats, T)
        self._dstate = self._dstate._replace(
            mode=jnp.int32(MODE_OK),
            T_cw=T,
            velocity=jnp.eye(4),
            last=feats,
            last_lms=lms,
            last_lms_valid=lms_valid,
            since_reloc=jnp.int32(0),
        )
        if self.records:
            self.records[-1] = SystemRecord(
                timestamp, self.ref_kf,
                np.asarray(T) @ np.linalg.inv(np.asarray(self.map.kf_pose[self.ref_kf])),
                False,
            )
        self._refresh_trkset()

    # ------------------------------------------------------------------
    # trajectory export (src/system.cpp:193-261)
    # ------------------------------------------------------------------
    def _kf_pose_with_tree_walk(self, kf: int, kf_pose, kf_valid, parent, T_c2p):
        """Walk up the spanning tree past culled keyframes, composing the
        frozen child-to-parent transforms (system.cpp:209-223)."""
        T_acc = np.eye(4)
        hops = 0
        while kf >= 0 and not kf_valid[kf] and hops < kf_pose.shape[0]:
            T_acc = T_acc @ T_c2p[kf]
            kf = int(parent[kf])
            hops += 1
        if kf < 0:
            return None
        return T_acc @ kf_pose[kf]

    def save_trajectory_tum(self, path: str):
        """Full per-frame trajectory relative to the first keyframe."""
        m = self.map
        kf_pose = np.asarray(m.kf_pose)
        kf_valid = np.asarray(m.kf_valid)
        parent = np.asarray(m.parent)
        T_c2p = np.asarray(m.kf_T_c2p)
        first = int(np.argmax(kf_valid))
        T_first_inv = np.linalg.inv(kf_pose[first])
        ts, poses, lost = [], [], []
        for rec in self.records:
            if rec.lost or rec.ref_kf < 0:
                continue
            T_ref = self._kf_pose_with_tree_walk(
                rec.ref_kf, kf_pose, kf_valid, parent, T_c2p
            )
            if T_ref is None:
                continue
            ts.append(rec.timestamp)
            poses.append(rec.T_c_ref @ T_ref @ T_first_inv)
            lost.append(False)
        write_tum_trajectory(path, ts, poses, lost, precision=9)

    def save_keyframe_trajectory_tum(self, path: str):
        m = self.map
        kf_valid = np.asarray(m.kf_valid)
        kf_pose = np.asarray(m.kf_pose)
        ts = np.asarray(m.kf_timestamp)
        order = np.argsort(np.asarray(m.kf_frame_id))
        sel = [k for k in order if kf_valid[k]]
        write_tum_trajectory(
            path, [float(ts[k]) for k in sel], [kf_pose[k] for k in sel],
            precision=7,
        )

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _record(self, timestamp, ok):
        if not self.records or self.records[-1].timestamp != timestamp:
            # tracking failed before any hook ran
            self.records.append(
                SystemRecord(timestamp, -1 if not self.n_keyframes else self.ref_kf,
                             np.eye(4), not ok)
            )
        self.frames_since_kf += 1
        # Auto-reset: lost right after initialization with a tiny map
        # (tracking.cpp:307-312: <= 5 keyframes).
        if (
            not ok
            and self.tracker.state == TrackingState.LOST
            and 0 < self.n_keyframes <= 5
        ):
            self.reset()

    def _local_map_hook(self, tracker: Tracker, timestamp, feats) -> bool:
        """Tracking::trackLocalMap (tracking.cpp:605-637) + keyframe
        decision/creation + the synchronous mapping pipeline."""
        cfg = self.cfg
        T_pred = tracker.new_T
        cap = self.cfg.capacity.tracking_points
        pts, pos, desc, normal, dmax, dmin, valid = _select_tracking_set(
            self.map, self.ref_kf, cap,
            self.cfg.tracking.local_window_max_kf,
        )
        assign, _ = match_local_points(
            self.cam, feats, T_pred, pos, desc, normal, dmax, dmin, valid,
            th=1.0, n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor,
            ratio=cfg.matcher.ratio_local_map, max_dist=cfg.matcher.th_high,
        )
        po = PoseObservations(
            p_w=pos[jnp.clip(assign, 0, cap - 1)],
            obs_uvr=jnp.concatenate([feats.uv, feats.right_u[:, None]], -1),
            inv_sigma2=self.inv_sigma2_tab[feats.octave],
            has_stereo=feats.right_u >= 0,
            valid=(assign >= 0) & feats.valid,
        )
        T_opt, inliers, n_in = optimize_pose(
            self.cam, T_pred, po,
            episodes=cfg.optim.pose_episodes,
            iters_per_episode=cfg.optim.pose_iters_per_episode,
        )
        n_in = int(n_in)
        # Stricter gate within 1 s of a relocalization
        # (tracking.cpp:630-636: 50 instead of 30 local-map inliers) —
        # parity with the device path's since_reloc handling.
        threshold = (
            cfg.tracking.min_matches_after_reloc
            if tracker.frames_since_reloc < max(1, int(cfg.camera.fps))
            else cfg.tracking.min_matches_local_map
        )
        if n_in < threshold:
            if self.localization_only and self.n_keyframes > 0:
                # Visual-odometry mode (tracking.cpp:407-441 +
                # m_b_isDoingVisualOdometry): the frozen map has too few
                # visible points, so keep the motion-model pose and track
                # frame-to-frame off the depth-seeded landmarks that
                # _adopt_frame backprojects — the reference's temporary
                # VO map points, without the allocation (its points exist
                # only to feed the next frame's motion search, which our
                # last-frame landmark array already is).  The map stays
                # untouched; normal map tracking resumes the moment
                # enough map points re-enter the frustum.
                self.visual_odometry = True
                T_ref = self.map.kf_pose[self.ref_kf]
                self.records.append(SystemRecord(
                    timestamp, self.ref_kf,
                    np.asarray(tracker.new_T @ jnp.linalg.inv(T_ref)), False,
                ))
                return True
            return False
        self.visual_odometry = False
        tracker.new_T = T_opt
        tracker.n_inliers = n_in
        self.stats.inlier_sum += n_in
        self.stats.inlier_frames += 1

        # Per-keypoint map-point ids of this frame (inliers only).
        mpid = jnp.where(
            inliers, pts[jnp.clip(assign, 0, cap - 1)], -1
        )
        self._frame_mpid = mpid
        # found/visible counters for the matched subset.
        matched_pts = jnp.where(assign >= 0, assign, -1)
        self.map = _bump_counters(
            self.map,
            jnp.where(matched_pts >= 0, pts[jnp.clip(matched_pts, 0, cap - 1)], -1),
            visible=jnp.ones_like(assign, dtype=bool),
            found=inliers,
        )
        # Let the tracker's motion model use optimized map-point
        # positions where available, depth backprojection elsewhere.
        lm_pos, lm_valid = landmark_positions(self.cam, feats, T_opt)
        mp_pos_assigned = self.map.mp_pos[jnp.clip(mpid, 0, self.map.M - 1)]
        tracker.pending_landmarks = (
            jnp.where((mpid >= 0)[:, None], mp_pos_assigned, lm_pos),
            lm_valid | (mpid >= 0),
        )

        # record trajectory relative to the reference keyframe
        T_ref = self.map.kf_pose[self.ref_kf]
        T_c_ref = np.asarray(T_opt @ jnp.linalg.inv(T_ref))
        self.records.append(
            SystemRecord(timestamp, self.ref_kf, T_c_ref, False)
        )

        if not self.localization_only and self._need_new_keyframe(feats, n_in):
            self._insert_keyframe(timestamp, feats, T_opt, matched_mp=mpid)
        return True

    def _rebase_records(self, culled, T_c2p, parent):
        """Eagerly migrate frame records off culled reference keyframes.

        Keyframe slots are REUSED after culling, so the lazy spanning-tree
        walk of the reference writer (system.cpp:209-223) would read a
        different keyframe's pose.  Instead, the moment a keyframe is
        culled we fold its frozen child-to-parent transform into every
        record that references it: T_c_ref <- T_c_ref @ T_c2p, ref <-
        parent.  Same math, eager instead of lazy, slot-reuse-safe.
        ``culled``/``T_c2p``/``parent`` come from mapping_step's packed
        snapshot (no extra device reads).
        """
        culled = set(culled)
        if not culled:
            return
        self.stats.keyframes_culled += len(culled)
        # Keep the retrieval index in sync (KeyFrameDatabase::erase).
        from .mapping import SNAP_CULL_CAP
        from .retrieval import remove_keyframes

        ids = np.full((SNAP_CULL_CAP,), -1, np.int32)
        ids[: len(culled)] = sorted(culled)[:SNAP_CULL_CAP]
        self.retrieval = remove_keyframes(self.retrieval, jnp.asarray(ids))
        if self.ref_kf in culled:
            p = int(parent[self.ref_kf])
            if p >= 0:
                self.ref_kf = p
        for rec in self.records:
            hops = 0
            while rec.ref_kf in culled and hops < len(parent):
                rec.T_c_ref = rec.T_c_ref @ T_c2p[rec.ref_kf]
                rec.ref_kf = int(parent[rec.ref_kf])
                hops += 1
            if rec.ref_kf < 0:
                rec.lost = True

    def _relocalize(self, tracker: Tracker, timestamp, feats) -> bool:
        """Tracking::relocalize (tracking.cpp:638-739): retrieval
        candidates -> dense appearance match (>= 15) -> vmapped PnP
        RANSAC -> pose-only LM -> accept at >= 50 inliers.

        The reference's alternating 5-iteration RANSAC rounds with
        progressively widened projection search (tracking.cpp:667-732)
        collapse into one 256-hypothesis batch plus the LM episodes —
        same gates, one device program per candidate.
        """
        import jax.random as jrandom

        from ..geometry.camera import backproject
        from ..optim.pnp import ransac_pose_3d3d
        from .matchers import match_dense as _match_dense
        from .retrieval import bow_histogram, detect_candidates

        cfg = self.cfg
        m = self.map
        if self.n_keyframes == 0:
            return False
        self.stats.reloc_attempts += 1
        q = bow_histogram(feats.desc, feats.valid, **self._bank_kw)
        ids, _ = detect_candidates(
            self.retrieval, q, jnp.zeros((m.K,), bool), m.covis,
            jnp.float32(-1.0), max_out=cfg.capacity.reloc_candidates,
        )
        if not hasattr(self, "_reloc_key"):
            self._reloc_key = jax.random.PRNGKey(7)
        for cand in [int(i) for i in np.asarray(ids) if i >= 0]:
            has_mp = m.kf_kp_valid[cand] & (m.kf_mp[cand] >= 0)
            assign, _ = _match_dense(
                m.kf_desc[cand], has_mp, m.kf_angle[cand],
                feats.desc, feats.valid, feats.angle,
                max_dist=cfg.matcher.th_low, ratio=cfg.matcher.ratio_reloc,
            )  # per frame-kp -> cand-kp
            if int(jnp.sum(assign >= 0)) < cfg.tracking.reloc_min_bow_matches:
                continue
            kp_c = jnp.clip(assign, 0, m.N - 1)
            mp = m.kf_mp[cand, kp_c]
            ok = (assign >= 0) & (mp >= 0) & m.mp_valid[jnp.clip(mp, 0, m.M - 1)]
            p_w = m.mp_pos[jnp.clip(mp, 0, m.M - 1)]
            sigma2 = 1.0 / self.inv_sigma2_tab[feats.octave]
            p_cam = backproject(self.cam, feats.uv, jnp.maximum(feats.depth, 1e-3))
            self._reloc_key, sub = jrandom.split(self._reloc_key)
            res = ransac_pose_3d3d(
                sub, self.cam, p_w, p_cam, feats.uv, sigma2,
                feats.depth > 0, ok & feats.valid,
                n_hypotheses=cfg.capacity.ransac_batch, min_inliers=10,
            )
            if not bool(res.ok):
                # Depth-sparse fallback: 2D-3D DLT-PnP (the reference's
                # EPnP relocalization solver, src/pnpSolver.cpp).  The
                # primary 3-point 3D-3D alignment needs measured frame
                # depth at the minimal-set picks — a far or
                # depth-dropout frame can match plenty of map points yet
                # offer too few depths to seed hypotheses from.
                from ..optim.pnp import ransac_pnp

                self._reloc_key, sub2 = jrandom.split(self._reloc_key)
                res = ransac_pnp(
                    sub2, self.cam, p_w, feats.uv, sigma2, ok & feats.valid,
                    n_hypotheses=cfg.capacity.ransac_batch, min_inliers=10,
                )
            if not bool(res.ok):
                continue
            po = PoseObservations(
                p_w=p_w,
                obs_uvr=jnp.concatenate([feats.uv, feats.right_u[:, None]], -1),
                inv_sigma2=self.inv_sigma2_tab[feats.octave],
                has_stereo=feats.right_u >= 0,
                valid=ok & feats.valid,
            )
            T_opt, inliers, n_in = optimize_pose(self.cam, res.T_cw, po)
            if int(n_in) < cfg.tracking.reloc_min_inliers:
                # Widen by projection against the candidate's map points
                # and re-optimize (tracking.cpp:702-732).
                ids = m.kf_mp[cand]
                idc = jnp.clip(ids, 0, m.M - 1)
                pvalid = (ids >= 0) & m.mp_valid[idc]
                assign2, _ = match_local_points(
                    self.cam, feats, T_opt,
                    m.mp_pos[idc], m.mp_desc[idc], m.mp_normal[idc],
                    m.mp_max_dist[idc], m.mp_min_dist[idc], pvalid,
                    th=3.0, n_levels=cfg.orb.n_levels,
                    scale_factor=cfg.orb.scale_factor,
                    ratio=cfg.matcher.ratio_local_map,
                    max_dist=cfg.matcher.th_high,
                )
                po2 = PoseObservations(
                    p_w=m.mp_pos[idc][jnp.clip(assign2, 0, m.N - 1)],
                    obs_uvr=jnp.concatenate(
                        [feats.uv, feats.right_u[:, None]], -1
                    ),
                    inv_sigma2=self.inv_sigma2_tab[feats.octave],
                    has_stereo=feats.right_u >= 0,
                    valid=(assign2 >= 0) & feats.valid,
                )
                T_opt, inliers, n_in = optimize_pose(self.cam, T_opt, po2)
            if int(n_in) >= cfg.tracking.reloc_min_inliers:
                tracker.new_T = T_opt
                tracker.T_cw = T_opt
                tracker.velocity = jnp.eye(4)
                tracker.n_inliers = int(n_in)
                self.ref_kf = cand
                self.stats.reloc_successes += 1
                return True
        return False

    def _need_new_keyframe(self, feats: FrameFeatures, n_in: int) -> bool:
        """Tracking::needNewKeyFrame (tracking.cpp:740-796), exact gates:
        minObs/refRatio relaxed while the map has < 3 keyframes, the
        close-point rule, cond1a/1b/1c and cond2.  cond1b's "local mapper
        idle" is always true here (mapping is synchronous)."""
        cfg = self.cfg
        if self.n_keyframes == 0:
            return True
        if self.localization_only:
            return False
        min_obs, ref_ratio = kf_decision_params(
            self.n_keyframes, cfg.tracking.kf_ref_ratio
        )
        ref_tracked = int(_count_ref_tracked(self.map, self.ref_kf, min_obs))
        # close-point bookkeeping (tracking.cpp:762-775)
        depth = np.asarray(feats.depth)
        mpid = np.asarray(self._frame_mpid)
        close = (depth > 0) & (depth <= self.depth_threshold)
        tracked_close = int((close & (mpid >= 0)).sum())
        untracked_close = int((close & (mpid < 0)).sum())
        need_close = (tracked_close < cfg.tracking.kf_close_tracked_max) and (
            untracked_close > cfg.tracking.kf_close_untracked_min
        )
        max_frames = max(1, int(self.cfg.camera.fps))
        c1a = self.frames_since_kf >= max_frames
        c1b = True  # minFrames=0 and mapping always idle (synchronous)
        c1c = n_in < ref_tracked * 0.25 or need_close
        c2 = n_in > 15 and (n_in < ref_tracked * ref_ratio or need_close)
        return (c1a or c1b or c1c) and c2

    def _alloc_kf_slot(self) -> Optional[int]:
        kf_valid = self._snapshot()["kf_valid"]
        free = np.where(~kf_valid)[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        # mark locally so back-to-back inserts between snapshot refreshes
        # do not collide
        self._snap["kf_valid"] = kf_valid.copy()
        self._snap["kf_valid"][slot] = True
        return slot

    def _insert_keyframe(
        self, timestamp, feats, T_cw, matched_mp=None, force=False,
        defer_ba=False, T_host=None,
    ):
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        if slot is None:
            # Capacity exhausted: every keyframe slot is live and culling
            # has not freed any.  The keyframe is skipped (tracking
            # continues against the existing map) — LOUDLY: silent skips
            # made capacity sizing errors invisible (VERDICT r3 weak #7).
            self.stats.keyframes_dropped_capacity += 1
            if self.stats.keyframes_dropped_capacity == 1:
                import warnings

                warnings.warn(
                    f"keyframe capacity exhausted (max_keyframes="
                    f"{self.cfg.capacity.max_keyframes}); new keyframes are "
                    "being dropped — raise CapacityConfig.max_keyframes for "
                    "this sequence length",
                    RuntimeWarning,
                    stacklevel=2,
                )
            return
        if matched_mp is None:
            matched_mp = self._no_match
        # Map initialization seeds a point for EVERY keypoint with depth
        # (tracking.cpp:343); later keyframes seed only close points
        # (tracking.cpp:804-837).
        depth_limit = (
            jnp.float32(1e9) if self.n_keyframes == 0 else self._depth_thr_dev
        )
        self.map, _ = insert_keyframe(
            self.map, slot, self.frame_id, timestamp, feats, T_cw, matched_mp,
            self.cam, depth_limit, jnp.int32(self.n_keyframes),
            scale_factor=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
            min_close_seed=cfg.tracking.min_close_seed_points,
        )
        self.n_keyframes += 1
        self.ref_kf = slot
        self.frames_since_kf = 0
        self.stats.keyframes_inserted += 1
        # Index the keyframe for place recognition (KeyFrameDatabase::add
        # serves both relocalization and loop detection).
        from .retrieval import add_keyframe as _retr_add

        self.retrieval = _retr_add(
            self.retrieval, slot, self.map.kf_desc[slot],
            self.map.kf_kp_valid[slot], **self._bank_kw,
        )

        if self.n_keyframes > 2:
            # The LocalMapping pipeline (cull -> triangulate -> fuse ->
            # local BA -> KF cull) runs as fused device programs with
            # on-device neighbor selection; the packed snapshot is
            # fetched asynchronously and consumed at the next host
            # decision point (localMapping.cpp:8-53, SURVEY.md §2c P1).
            # ``defer_ba`` runs only the per-keyframe half here and
            # leaves the BA half to the caller's batch boundary
            # (interruptBA semantics, localMapping.cpp:54-58).
            win_cap, fix_cap, pts_cap = self._ba_caps()
            if defer_ba:
                from .mapping import mapping_prep

                self.map = mapping_prep(
                    self.map, jnp.int32(slot), jnp.int32(self.n_keyframes),
                    self.cam,
                    scale_factor=cfg.orb.scale_factor,
                    n_levels=cfg.orb.n_levels,
                    **self._prep_kw,
                )
                self._ba_pending = True
                # Host-side snapshot patch: subsequent records in this
                # batch decompose against the NEW reference keyframe.
                if T_host is not None and getattr(self, "_snap", None):
                    self._snap["ref_pose"] = np.asarray(T_host, np.float64)
                    fid = np.array(self._snap["kf_frame_id"])
                    fid[slot] = self.frame_id
                    self._snap["kf_frame_id"] = fid
            else:
                from .mapping import mapping_step

                self.stats.local_ba_runs += 1
                self.map, snap_vec = mapping_step(
                    self.map, jnp.int32(slot), jnp.int32(self.n_keyframes),
                    self.cam, self.inv_sigma2_tab,
                    self._depth_thr_dev,
                    scale_factor=cfg.orb.scale_factor,
                    n_levels=cfg.orb.n_levels,
                    iters1=cfg.optim.local_ba_iters_1,
                    iters2=cfg.optim.local_ba_iters_2,
                    win_cap=win_cap,
                    fix_cap=fix_cap,
                    pts_cap=pts_cap,
                    obs_cap=cfg.capacity.local_ba_obs,
                    kf_cull_redundancy=cfg.mapping.kf_cull_redundancy,
                    **self._prep_kw,
                )
                self._stash_snapshot(snap_vec)
        else:
            self._refresh_snapshot()
        if self.loop_closer is not None and self.n_keyframes > 2:
            self.loop_closer.process(slot)
