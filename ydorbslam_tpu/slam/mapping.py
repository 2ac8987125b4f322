"""Local mapping: point culling, local BA windowing, keyframe culling.

Replaces the reference ``LocalMapping`` thread (src/localMapping.cpp):
the queue-consumer loop becomes synchronous host orchestration (the
pipeline-parallelism decision of SURVEY.md §2c P1 — batched on-chip work
instead of thread interleaving); each step is a jitted
MapState -> MapState function.

  * cullMapPoint (localMapping.cpp:90-108): found-ratio < 0.25, or
    too-few observations within 2 keyframes of creation.
  * local BA (optimizer.cpp:138-352): covisibility window around the
    new keyframe, fixed observer cameras, two-phase Schur LM
    (optim/schur.py), outlier observation erasure.
  * cullKeyFrame (localMapping.cpp:371-405): 90% of close points seen
    >= 3 times elsewhere at same/finer scale.

Triangulation of new points between keyframes (createNewMapPoints) and
neighbor fusion live in slam/triangulate.py.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import inv_T
from ..optim.schur import BAProblem, bundle_adjust
from .map_state import (MapState, erase_observations, recount_obs,
                        recount_obs_weighted)

# Default local BA capacity split: optimized window + fixed observers.
LBA_WIN = 64
LBA_FIX = 32
LBA_PTS = 4096


@functools.partial(
    jax.jit, static_argnames=("found_ratio", "min_obs"), donate_argnums=(0,)
)
def cull_map_points(
    m: MapState,
    current_kf_count: jax.Array,
    found_ratio: float = 0.25,
    min_obs: int = 3,
) -> MapState:
    """Recent-map-point culling (localMapping.cpp:90-108).

    found/visible ratio < ``found_ratio`` (0.25) -> cull;
    point created >= 2 KFs ago with <= ``min_obs`` (3) observations ->
    cull.  (Points older than 3 KFs are permanent in the reference;
    encoded here by only applying the obs test inside the 2..3-KF
    window.)
    """
    ratio = m.mp_found.astype(jnp.float32) / jnp.maximum(m.mp_visible, 1)
    # Weighted count: stereo observations count double
    # (mapPoint.cpp:96-99) — an RGB-D seed (2) + one keyframe rebind (2)
    # = 4 > 3 survives; with a flat count every depth-seeded point died
    # here unless THREE keyframes rebound it within 2 insertions, which
    # starved old keyframes of bindings and the whole map of
    # observations (the r5 root-cause chain).
    n_obs = recount_obs_weighted(m)
    n_obs_raw = recount_obs(m)
    age = current_kf_count - m.mp_first_kf  # in keyframe insertions
    # The reference checks each recent point once at age 2 (>=2 in code,
    # but survivors leave the recent list at age 3 so the test fires
    # exactly once); points passing it are permanent.  The found-ratio
    # rule likewise applies only while the point is IN the recent list
    # (localMapping.cpp:90-108) — survivors become permanent, so a
    # mature point's ratio dipping under load must not retro-cull it.
    bad = m.mp_valid & (
        ((ratio < found_ratio) & (age <= 3))
        | ((age == 2) & (n_obs <= min_obs))
        | (n_obs_raw == 0)
    )
    # Compact the dead set to a fixed budget and clear their bindings
    # THROUGH their observation lists (exact (kf, kp) positions; the
    # obs<->binding invariant is maintained by obs_has_free gating at
    # every bind site), instead of a dense (K, N)-sized gather from the
    # (M,) validity table.  Overflow beyond the budget survives to the
    # next call — its cull conditions persist.
    CULL_CAP = 1024
    bvals, bids = jax.lax.top_k(bad.astype(jnp.int32), min(CULL_CAP, m.M))
    bok = bvals > 0
    bidc = jnp.clip(bids, 0, m.M - 1)
    row_w = jnp.where(bok, bidc, m.M)  # M -> dropped
    mp_valid = m.mp_valid.at[row_w].set(False, mode="drop")
    okf = m.mp_obs_kf[bidc]  # (CAP,O)
    okp = m.mp_obs_kp[bidc]
    kill = bok[:, None] & (okf >= 0)
    kfw = jnp.where(kill, okf, m.K)
    kf_mp = m.kf_mp.at[kfw.reshape(-1), jnp.clip(okp, 0, m.N - 1).reshape(-1)].set(
        -1, mode="drop"
    )
    mp_obs_kf = m.mp_obs_kf.at[row_w].set(-1, mode="drop")
    mp_obs_kp = m.mp_obs_kp.at[row_w].set(-1, mode="drop")
    return m._replace(
        mp_valid=mp_valid, kf_mp=kf_mp, mp_obs_kf=mp_obs_kf, mp_obs_kp=mp_obs_kp
    )


@functools.partial(jax.jit, static_argnames=("win_cap", "fix_cap", "pts_cap"))
def select_local_window(
    m: MapState, kf_id, win_cap: int = LBA_WIN, fix_cap: int = LBA_FIX,
    pts_cap: int = LBA_PTS,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Pick (window_kfs (LBA_WIN,), fixed_kfs (LBA_FIX,), point_ids (LBA_PTS,)).

    Window = the keyframe + its covisible neighbors by weight
    (optimizer.cpp:142-173); points = everything those observe; fixed =
    other keyframes observing those points.  All index lists are -1
    padded to their caps (weight-ordered truncation when over cap).
    """
    w = m.covis[kf_id] * m.kf_valid.astype(jnp.int32)
    w = w.at[kf_id].set(1 << 20)  # self first
    vals, win = jax.lax.top_k(w, min(win_cap, m.K))
    win = jnp.where(vals > 0, win, -1)
    if win.shape[0] < win_cap:
        win = jnp.pad(win, (0, win_cap - win.shape[0]), constant_values=-1)

    # Points observed by the window: gather only the window keyframes'
    # binding rows (win_cap x N) — scattering from the full (K, N) table
    # costs ~10ms of serialized scatter for mostly-dead rows.
    winc = jnp.clip(win, 0, m.K - 1)
    win_mp = m.kf_mp[winc]  # (win_cap, N)
    win_sel = (win >= 0)[:, None] & (win_mp >= 0)
    in_win = jnp.zeros((m.K + 1,), bool).at[jnp.where(win >= 0, win, m.K)].set(
        win >= 0
    )[: m.K]
    member = jnp.zeros((m.M,), bool).at[
        jnp.clip(win_mp, 0, m.M - 1)
    ].max(win_sel, mode="drop")
    member &= m.mp_valid
    order = jnp.where(member, jnp.arange(m.M), m.M)
    pts = jnp.sort(order)[:pts_cap].astype(jnp.int32)
    pts = jnp.where(pts < m.M, pts, -1)

    # Fixed keyframes: observers of selected points outside the window.
    ptc = jnp.clip(pts, 0, m.M - 1)
    obs_k = m.mp_obs_kf[ptc]  # (pts_cap, O)
    obs_ok = (pts[:, None] >= 0) & (obs_k >= 0)
    observer = jnp.zeros((m.K,), bool).at[
        jnp.clip(obs_k, 0, m.K - 1)
    ].max(obs_ok, mode="drop")
    fixed_mask = observer & m.kf_valid & ~in_win
    # Order fixed KFs by covisibility with the center keyframe.
    fw = jnp.where(fixed_mask, m.covis[kf_id] + 1, -1)
    fvals, fixed = jax.lax.top_k(fw, min(fix_cap, m.K))
    fixed = jnp.where(fvals > 0, fixed, -1)
    if fixed.shape[0] < fix_cap:
        fixed = jnp.pad(fixed, (0, fix_cap - fixed.shape[0]), constant_values=-1)
    return win, fixed, pts


@functools.partial(jax.jit, static_argnames=("obs_cap",))
def build_local_ba(
    m: MapState, win: jax.Array, fixed: jax.Array, pts: jax.Array,
    inv_sigma2_tab: jax.Array, obs_cap: int = 0,
) -> BAProblem:
    """Gather the capacity-bounded BAProblem for the local window.

    ``obs_cap`` > 0 compacts each point's observation slots to the
    best ``obs_cap`` (in-window observations first): Q = P*O drives the
    whole LM cost, and points with more than ~16 observers inside one
    local window contribute almost no extra constraint.
    """
    C = win.shape[0] + fixed.shape[0]
    cams = jnp.concatenate([win, fixed])  # (C,)
    cam_ok = cams >= 0
    camc = jnp.clip(cams, 0, m.K - 1)
    T = m.kf_pose[camc]
    cam_fixed = jnp.arange(C) >= win.shape[0]
    # KF id 0 (the map origin) is always fixed (optimizer.cpp:27,176).
    cam_fixed |= m.kf_frame_id[camc] == m.kf_frame_id[jnp.argmax(m.kf_valid)]
    # LUT keyframe id -> local cam index.
    lut = jnp.full((m.K,), -1, jnp.int32).at[
        jnp.where(cam_ok, camc, 0)
    ].set(jnp.where(cam_ok, jnp.arange(C, dtype=jnp.int32), -1), mode="drop")

    ptc = jnp.clip(pts, 0, m.M - 1)
    pt_ok = (pts >= 0) & m.mp_valid[ptc]
    obs_kf = m.mp_obs_kf[ptc]  # (P,O)
    obs_kp = m.mp_obs_kp[ptc]
    obs_cam = jnp.where(obs_kf >= 0, lut[jnp.clip(obs_kf, 0, m.K - 1)], -1)
    obs_sel = jnp.broadcast_to(
        jnp.arange(obs_cam.shape[1], dtype=jnp.int32)[None, :], obs_cam.shape
    )
    if obs_cap and obs_cap < obs_cam.shape[1]:
        order = jnp.argsort(-(obs_cam >= 0).astype(jnp.int32), axis=1)[
            :, :obs_cap
        ]
        obs_kf = jnp.take_along_axis(obs_kf, order, axis=1)
        obs_kp = jnp.take_along_axis(obs_kp, order, axis=1)
        obs_cam = jnp.take_along_axis(obs_cam, order, axis=1)
        obs_sel = order.astype(jnp.int32)
    kfc = jnp.clip(obs_kf, 0, m.K - 1)
    kpc = jnp.clip(obs_kp, 0, m.N - 1)
    uv = m.kf_uv[kfc, kpc]
    ur = m.kf_right_u[kfc, kpc]
    obs_uvr = jnp.concatenate([uv, ur[..., None]], axis=-1)
    octv = m.kf_octave[kfc, kpc]
    obs_valid = pt_ok[:, None] & (obs_cam >= 0) & m.kf_kp_valid[kfc, kpc]
    return BAProblem(
        T_cw=T,
        cam_fixed=cam_fixed,
        cam_valid=cam_ok,
        p_w=m.mp_pos[ptc],
        pt_valid=pt_ok,
        obs_cam=obs_cam,
        obs_uvr=obs_uvr,
        obs_inv_sigma2=inv_sigma2_tab[octv],
        obs_stereo=ur >= 0,
        obs_valid=obs_valid,
    ), obs_sel


@functools.partial(jax.jit, donate_argnums=(0,))
def apply_local_ba(
    m: MapState,
    win: jax.Array,
    pts: jax.Array,
    T_new: jax.Array,
    p_new: jax.Array,
    outlier: jax.Array,
    obs_sel: jax.Array,
) -> MapState:
    """Write back optimized poses/points and erase outlier observations
    (the under-map-mutex recovery step of optimizer.cpp:336-352 — here
    just a functional update).  ``outlier`` is indexed by the COMPACTED
    observation slots; ``obs_sel`` (P, obs_cap) maps them back to each
    point's original O-slot indices."""
    win_ok = win >= 0
    winc = jnp.where(win_ok, win, 0)
    kf_pose = m.kf_pose.at[winc].set(
        jnp.where(win_ok[:, None, None], T_new[: win.shape[0]], m.kf_pose[winc]),
        mode="drop",
    )
    pt_ok = pts >= 0
    ptc = jnp.where(pt_ok, pts, 0)
    mp_pos = m.mp_pos.at[ptc].set(
        jnp.where(pt_ok[:, None], p_new, m.mp_pos[ptc]), mode="drop"
    )
    m = m._replace(kf_pose=kf_pose, mp_pos=mp_pos)

    # Erase outlier observations: clear mp_obs slot + kf_mp slot.
    rows = m.mp_obs_kf[jnp.clip(ptc, 0, m.M - 1)]  # (P,O) full rows
    obs_kf = jnp.take_along_axis(rows, obs_sel, axis=1)  # (P,Oc)
    obs_kp = jnp.take_along_axis(
        m.mp_obs_kp[jnp.clip(ptc, 0, m.M - 1)], obs_sel, axis=1
    )
    kill = outlier & pt_ok[:, None] & (obs_kf >= 0)
    pt_w = jnp.where(kill, ptc[:, None], m.M)  # dropped when not killed
    mp_obs_kf = m.mp_obs_kf.at[pt_w, obs_sel].set(-1, mode="drop")
    mp_obs_kp = m.mp_obs_kp.at[pt_w, obs_sel].set(-1, mode="drop")
    kf_w = jnp.where(kill, obs_kf, 0)
    kp_w = jnp.where(kill, obs_kp, 0)
    kf_mp = m.kf_mp.at[kf_w.reshape(-1), kp_w.reshape(-1)].set(
        jnp.where(kill.reshape(-1), -1, m.kf_mp[kf_w.reshape(-1), kp_w.reshape(-1)]),
        mode="drop",
    )
    return m._replace(mp_obs_kf=mp_obs_kf, mp_obs_kp=mp_obs_kp, kf_mp=kf_mp)


# ----------------------------------------------------------------------
# Fused per-keyframe mapping program
# ----------------------------------------------------------------------

# Packed snapshot layout returned by mapping_step (one f32 vector so the
# host fetches everything it needs with a single async copy instead of
# one device->host synchronization per field).
SNAP_CULL_CAP = 16  # >= keyframe-culling NCAND


def snapshot_layout(K: int):
    """(offsets dict, total length) of the packed mapping snapshot."""
    off, o = {}, 0
    for name, ln in (
        ("kf_valid", K),
        ("valid_before", K),
        ("parent", K),
        ("kf_frame_id", K),
        ("ref_pose", 16),
        ("culled_ids", SNAP_CULL_CAP),
        ("culled_c2p", SNAP_CULL_CAP * 16),
        ("culled_parent", SNAP_CULL_CAP),
    ):
        off[name] = (o, o + ln)
        o += ln
    return off, o


def _prep_core(
    m: MapState,
    kf_id,
    kf_count,
    cam: CameraIntrinsics,
    scale_factor: float,
    n_levels: int,
    n_neighbors: int,
    cull_found_ratio: float = 0.25,
    cull_min_obs: int = 3,
    tri_ratio: float = 0.6,
):
    """Per-keyframe map maintenance: cull recent points -> on-device
    covisible-neighbor top-k -> BATCHED epipolar triangulation over all
    neighbors -> point refresh -> batched two-way fusion over the
    first- AND second-order neighbor set -> refresh -> covisibility
    refresh (localMapping.cpp:63-294 without the BA/cull tail).  The
    reference's sequential per-neighbor loop becomes one vmapped
    candidate search per phase — ~2x less device time than the
    fori_loop formulation."""
    from .map_state import refresh_points, update_covisibility
    from .triangulate import fuse_neighbors_batch, triangulate_neighbors_batch

    m = cull_map_points.__wrapped__(
        m, kf_count, found_ratio=cull_found_ratio, min_obs=cull_min_obs
    )

    w = m.covis[kf_id] * m.kf_valid.astype(jnp.int32)
    nvals, nids = jax.lax.top_k(w, min(n_neighbors, m.K))
    nok = nvals > 0

    # Triangulation pairs with the FIRST-order neighbors only
    # (createNewMapPoints, localMapping.cpp:111).
    m = triangulate_neighbors_batch(
        m, kf_id, nids, nok, kf_count, cam, scale_factor, n_levels,
        ratio=tri_ratio,
    )
    m = refresh_points(
        m, jnp.where(m.kf_mp[kf_id] >= 0, m.kf_mp[kf_id], -1),
        scale_factor, n_levels,
    )
    # Fuse targets extend to the SECOND-order neighborhood
    # (searchInNeighbors, localMapping.cpp:253-267: 10 direct + 5 per
    # direct neighbor).  The expansion is what spreads observations
    # beyond the insertion chain — without it points plateau at
    # visibility-span obs counts and the age-2 cull wipes them.
    K = m.K
    first_mask = jnp.zeros((K,), bool).at[
        jnp.where(nok, nids, K)
    ].set(True, mode="drop")
    w2 = jnp.max(
        jnp.where(nok[:, None], m.covis[jnp.clip(nids, 0, K - 1)], 0),
        axis=0,
    )
    w2 = jnp.where(
        first_mask | (jnp.arange(K) == kf_id) | ~m.kf_valid, 0, w2
    )
    n2 = min(n_neighbors, m.K)
    n2vals, n2ids = jax.lax.top_k(w2, n2)
    fuse_ids = jnp.concatenate([nids, n2ids.astype(jnp.int32)])
    fuse_ok = jnp.concatenate([nok, n2vals > 0])
    m = fuse_neighbors_batch(
        m, kf_id, fuse_ids, fuse_ok, cam, scale_factor, n_levels
    )
    m = refresh_points(
        m, jnp.where(m.kf_mp[kf_id] >= 0, m.kf_mp[kf_id], -1),
        scale_factor, n_levels,
    )
    # NOTE deliberate deviation: the reference refreshes connections here
    # (updateConnections, localMapping.cpp:292).  Measured on the drifted
    # orbit artifact, the refreshed (richer) covisibility pulls older
    # keyframes with drift-conflicted geometry into the local-BA window
    # and tracking destabilizes (51 lost frames vs 0 without).  The
    # loop-closure path recomputes the FULL graph on device at correction
    # time (map_state.recompute_covis_all), so the essential graph still
    # sees post-fusion weights; day-to-day covisibility comes from
    # insertion-time updates.
    return m


def _finish_core(
    m: MapState,
    kf_id,
    cam: CameraIntrinsics,
    inv_sigma2_tab: jax.Array,
    depth_threshold: jax.Array,
    iters1: int,
    iters2: int,
    win_cap: int,
    fix_cap: int,
    pts_cap: int,
    obs_cap: int,
    kf_cull_redundancy: float = 0.9,
):
    """Local BA + redundant-keyframe culling + packed snapshot
    (localMapping.cpp:29,371-405; optimizer.cpp:138-352).

    Split from ``_prep_core`` so the pipelined system can run it once
    per drained keyframe BATCH instead of per keyframe: the reference's
    local BA is force-stopped the moment a new keyframe enters the queue
    (``interruptBA``, localMapping.cpp:54-58, optimizer.cpp:17-19), so
    with several queued keyframes only the last one gets an
    uninterrupted BA — this is the batch-drain equivalent.
    """
    win, fixed, pts = select_local_window.__wrapped__(
        m, kf_id, win_cap, fix_cap, pts_cap
    )
    prob, obs_sel = build_local_ba.__wrapped__(
        m, win, fixed, pts, inv_sigma2_tab, obs_cap=obs_cap
    )
    T_new, p_new, outlier = bundle_adjust.__wrapped__(
        cam, prob, iters1=iters1, iters2=iters2
    )
    m = apply_local_ba.__wrapped__(
        m, win, pts, T_new[:win_cap], p_new, outlier, obs_sel
    )

    valid_before = m.kf_valid
    m = cull_keyframes.__wrapped__(
        m, kf_id, depth_threshold, redundancy=kf_cull_redundancy
    )

    # --- packed snapshot ------------------------------------------------
    culled = valid_before & ~m.kf_valid
    kcap = min(SNAP_CULL_CAP, m.K)  # tiny-capacity maps: K can be < CAP
    cvals, cids = jax.lax.top_k(culled.astype(jnp.int32), kcap)
    cids = jnp.where(cvals > 0, cids, -1)
    if kcap < SNAP_CULL_CAP:
        cids = jnp.pad(cids, (0, SNAP_CULL_CAP - kcap), constant_values=-1)
    cidc = jnp.clip(cids, 0, m.K - 1)
    # Freeze child->parent transforms of the culled nodes for record
    # rebasing (kf_T_c2p was just written by cull_keyframes).
    c2p = m.kf_T_c2p[cidc]  # (CAP,4,4)
    snap = jnp.concatenate(
        [
            m.kf_valid.astype(jnp.float32),
            valid_before.astype(jnp.float32),
            m.parent.astype(jnp.float32),
            m.kf_frame_id.astype(jnp.float32),
            m.kf_pose[kf_id].reshape(16),
            cids.astype(jnp.float32),
            c2p.reshape(-1),
            m.parent[cidc].astype(jnp.float32),
        ]
    )
    return m, snap


@functools.partial(
    jax.jit,
    static_argnames=(
        "scale_factor", "n_levels", "n_neighbors",
        "cull_found_ratio", "cull_min_obs", "tri_ratio",
    ),
    donate_argnums=(0,),
)
def mapping_prep(
    m: MapState,
    kf_id,
    kf_count,
    cam: CameraIntrinsics,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    n_neighbors: int = 10,
    cull_found_ratio: float = 0.25,
    cull_min_obs: int = 3,
    tri_ratio: float = 0.6,
):
    """Jitted per-keyframe half of the mapping pipeline (no BA)."""
    return _prep_core(
        m, kf_id, kf_count, cam, scale_factor, n_levels, n_neighbors,
        cull_found_ratio, cull_min_obs, tri_ratio,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "iters1", "iters2", "win_cap", "fix_cap", "pts_cap", "obs_cap",
        "kf_cull_redundancy",
    ),
    donate_argnums=(0,),
)
def mapping_finish(
    m: MapState,
    kf_id,
    cam: CameraIntrinsics,
    inv_sigma2_tab: jax.Array,
    depth_threshold: jax.Array,
    iters1: int = 5,
    iters2: int = 10,
    win_cap: int = LBA_WIN,
    fix_cap: int = LBA_FIX,
    pts_cap: int = LBA_PTS,
    obs_cap: int = 0,
    kf_cull_redundancy: float = 0.9,
):
    """Jitted per-batch half: local BA + KF culling + snapshot."""
    return _finish_core(
        m, kf_id, cam, inv_sigma2_tab, depth_threshold,
        iters1, iters2, win_cap, fix_cap, pts_cap, obs_cap,
        kf_cull_redundancy,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "scale_factor", "n_levels", "iters1", "iters2",
        "win_cap", "fix_cap", "pts_cap", "obs_cap", "n_neighbors",
        "cull_found_ratio", "cull_min_obs", "tri_ratio",
        "kf_cull_redundancy",
    ),
    donate_argnums=(0,),
)
def mapping_step(
    m: MapState,
    kf_id,
    kf_count,
    cam: CameraIntrinsics,
    inv_sigma2_tab: jax.Array,
    depth_threshold: jax.Array,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    iters1: int = 5,
    iters2: int = 10,
    win_cap: int = LBA_WIN,
    fix_cap: int = LBA_FIX,
    pts_cap: int = LBA_PTS,
    obs_cap: int = 0,
    n_neighbors: int = 10,
    cull_found_ratio: float = 0.25,
    cull_min_obs: int = 3,
    tri_ratio: float = 0.6,
    kf_cull_redundancy: float = 0.9,
):
    """The WHOLE per-keyframe LocalMapping pipeline as ONE device
    program (localMapping.cpp:8-53 re-expressed): ``_prep_core`` (cull,
    triangulate, fuse, refresh) followed by ``_finish_core`` (local BA,
    keyframe culling, packed snapshot).

    The reference runs this on its mapping thread with ~30 fine-grained
    steps; dispatching those individually from the host would
    synchronize with the device at each.  Host control flow needs
    nothing mid-pipeline: neighbor selection moves on device, and the
    packed snapshot (second return) carries everything the host's
    bookkeeping reads, fetched asynchronously.

    Returns (map', snapshot_vec (SNAP_LEN,) f32).
    """
    m = _prep_core(
        m, kf_id, kf_count, cam, scale_factor, n_levels, n_neighbors,
        cull_found_ratio, cull_min_obs, tri_ratio,
    )
    return _finish_core(
        m, kf_id, cam, inv_sigma2_tab, depth_threshold,
        iters1, iters2, win_cap, fix_cap, pts_cap, obs_cap,
        kf_cull_redundancy,
    )


@functools.partial(
    jax.jit, static_argnames=("redundancy",), donate_argnums=(0,)
)
def cull_keyframes(
    m: MapState, kf_id, depth_threshold: jax.Array,
    redundancy: float = 0.9,
) -> MapState:
    """Redundant-keyframe culling (localMapping.cpp:371-405).

    A covisible keyframe of ``kf_id`` is culled when >= ``redundancy``
    (90%) of its close map points are observed by >= 3 other keyframes
    at the same or finer scale.  Spanning-tree children are re-parented
    to their max-covisibility older keyframe (keyFrame.cpp:256-327),
    falling back to the culled node's parent.  The first keyframe is
    never culled.
    """
    # Candidates: top covisible neighbors of the current keyframe.  The
    # per-point observation gather below is the expensive part, so it
    # runs only over a fixed candidate window (the reference also only
    # examines covisible keyframes, localMapping.cpp:372).
    NCAND = 16
    w = m.covis[kf_id] * m.kf_valid.astype(jnp.int32)
    first_kf = jnp.argmax(m.kf_valid)
    w = w.at[first_kf].set(0).at[kf_id].set(0)
    wvals, cand_ids = jax.lax.top_k(w, min(NCAND, m.K))
    cand_ok = wvals > 0
    candc = jnp.clip(cand_ids, 0, m.K - 1)

    ids = jnp.clip(m.kf_mp[candc], 0, m.M - 1)  # (NC,N)
    pt_live = (m.kf_mp[candc] >= 0) & m.mp_valid[ids] & m.kf_kp_valid[candc]
    close = pt_live & (m.kf_depth[candc] > 0) & (
        m.kf_depth[candc] <= depth_threshold
    )
    oct_here = m.kf_octave[candc]  # (NC,N)
    # Count observations at same-or-finer scale from the per-point
    # octave histogram (mp_obs_oct is denormalized at add time; the
    # two-level kf_octave[obs_kf, obs_kp] gather it replaces costs ~20ms
    # for the NC*N*O index set).  cnt_le[m, t] = #live obs with
    # octave <= t; the candidate's own observation always satisfies
    # octave <= octave+1, so "other observers" = cnt_le - 1.
    obs_live_all = m.mp_obs_kf >= 0  # (M,O)
    hist = jnp.sum(
        jnp.where(
            obs_live_all[..., None],
            jax.nn.one_hot(jnp.clip(m.mp_obs_oct, 0, 8), 9, dtype=jnp.int32),
            0,
        ),
        axis=1,
    )  # (M,9)
    cnt_le = jnp.cumsum(hist, axis=-1)  # (M,9)
    t = jnp.clip(oct_here + 1, 0, 8)  # (NC,N)
    cnt_rows = cnt_le[ids]  # (NC,N,9) row gather
    n_finer = jnp.take_along_axis(cnt_rows, t[..., None], axis=-1)[..., 0] - 1
    redundant_pt = close & (n_finer >= 3)
    n_close = jnp.sum(close, axis=-1)  # (NC,)
    n_red = jnp.sum(redundant_pt, axis=-1)
    cull_cand = cand_ok & (n_close > 10) & (
        n_red.astype(jnp.float32) > redundancy * n_close.astype(jnp.float32)
    )
    # Never cull a tree root: the trajectory writer must be able to walk
    # from any culled node to a live ancestor.
    cull_cand &= m.parent[candc] >= 0
    cull = jnp.zeros((m.K,), bool).at[candc].max(cull_cand, mode="drop")

    kf_valid = m.kf_valid & ~cull
    # Freeze the culled keyframes' pose relative to their parent so the
    # trajectory writer can walk the spanning tree (system.cpp:209-232).
    par = jnp.clip(m.parent, 0, m.K - 1)
    T_par_inv = inv_T(m.kf_pose[par])
    T_c2p = jnp.einsum("kij,kjl->kil", m.kf_pose, T_par_inv)
    kf_T_c2p = jnp.where(cull[:, None, None], T_c2p, m.kf_T_c2p)
    # Erase observations made by culled keyframes.  Only the NC
    # candidates can be culled, so walk THEIR point bindings and clear
    # the matching obs slots — scanning all (M, O) obs slots for culled
    # owners is a 2M-element gather (~35ms); this is 16k rows.
    # (Duplicate point rows — a point bound by TWO culled candidates in
    # the same call — resolve last-writer-wins and can leave one stale
    # obs behind; consumers that matter resolve observers against live
    # keyframe sets, so a stale slot only slightly inflates obs counts
    # until the point is next refreshed.)
    obs_rows = m.mp_obs_kf[ids.reshape(-1)]  # (NC*N, O)
    owner = jnp.repeat(candc, m.N)  # (NC*N,)
    live_row = (pt_live & cull_cand[:, None]).reshape(-1)
    hit = (obs_rows == owner[:, None]) & live_row[:, None]
    # Only rows of CULLED candidates write back (others route to the
    # dropped out-of-range row) so a point shared with a surviving
    # neighbor cannot overwrite the cleared slots with its stale copy.
    row_w = jnp.where(live_row, ids.reshape(-1), m.M)
    mp_obs_kf = m.mp_obs_kf.at[row_w].set(
        jnp.where(hit, -1, obs_rows), mode="drop"
    )
    mp_obs_kp = m.mp_obs_kp.at[row_w].set(
        jnp.where(hit, -1, m.mp_obs_kp[ids.reshape(-1)]), mode="drop"
    )
    kf_mp = jnp.where(cull[:, None], -1, m.kf_mp)
    # Re-parent children of culled nodes to their MAX-COVISIBILITY live
    # keyframe (KeyFrame::setBadFlag, keyFrame.cpp:256-327).  The
    # reference grows a candidate set from the culled node's parent;
    # here candidates are all surviving keyframes STRICTLY OLDER (by
    # frame id) than the child — spanning-tree edges always point to
    # older keyframes by construction, so acyclicity is preserved
    # without the reference's incremental set.  Fallback when no
    # covisible older keyframe exists: the culled node's own parent.
    parent_culled = cull[jnp.clip(m.parent, 0, m.K - 1)] & (m.parent >= 0)
    older = (
        kf_valid[None, :]
        & (m.kf_frame_id[None, :] < m.kf_frame_id[:, None])
    )
    w_child = jnp.where(older, m.covis, -1)  # (K,K)
    best_w = jnp.max(w_child, axis=1)
    best_cand = jnp.argmax(w_child, axis=1).astype(m.parent.dtype)
    grand = m.parent[jnp.clip(m.parent, 0, m.K - 1)]
    # Only LIVE children re-parent: an already-culled child's frozen
    # T_c2p is relative to its recorded parent, so its pointer must not
    # move — the chain walk composes frozen transforms link by link
    # (the culled-now parent keeps its own frozen T_c2p + parent entry,
    # so the chain through it stays resolvable).
    new_parent = jnp.where(
        parent_culled & kf_valid,
        jnp.where(best_w > 0, best_cand, grand),
        m.parent,
    )
    covis = jnp.where(cull[:, None] | cull[None, :], 0, m.covis)
    return m._replace(
        kf_valid=kf_valid,
        kf_mp=kf_mp,
        mp_obs_kf=mp_obs_kf,
        mp_obs_kp=mp_obs_kp,
        parent=new_parent,
        covis=covis,
        kf_T_c2p=kf_T_c2p,
    )
