"""Data-association searches as dense masked matrix ops.

Replaces the reference's 9 ``OrbMatcher::search*/fuse*`` strategies
(src/orbMatcher.cpp:24-807).  Each reference search walks per-keypoint
candidate lists gathered from the 64x48 occupancy grid; here every
search is ONE masked (M, N) Hamming distance matrix (ops/hamming.py)
with the geometric pruning expressed as boolean masks — projection
windows, octave gates, view-cos radii, epipolar bands.  The dense form
avoids gathers, vectorizes the ratio tests, and makes duplicate
resolution (two sources claiming one keypoint) an exact
argmin instead of the reference's insertion-order overwrite.

Shared constants: TH_HIGH=100, TH_LOW=50, HISTO=30
(src/orbMatcher.cpp:7-9).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import inv_T
from ..ops.extractor import FrameFeatures
from ..ops.best2 import best2
from ..ops.hamming import (
    INVALID_DIST,
    masked_distance_matrix,
    rotation_histogram_mask,
)

TH_HIGH = 100
TH_LOW = 50


def _pack_src_attr(u, v, ur, rad_narrow, rad_wide, oct_lo, oct_hi, valid):
    """Row-side attribute lanes for ops.best2 (A_* layout), (M, 8)."""
    f = jnp.float32
    return jnp.stack(
        [
            u.astype(f), v.astype(f), ur.astype(f),
            rad_narrow.astype(f), rad_wide.astype(f),
            oct_lo.astype(f), oct_hi.astype(f),
            valid.astype(f),
        ],
        axis=-1,
    )


def _pack_cur_attr(curr: FrameFeatures):
    """Column-side attribute lanes (B_* layout) of the current frame."""
    f = jnp.float32
    z = jnp.zeros_like(curr.angle)
    return jnp.stack(
        [
            curr.uv[:, 0].astype(f), curr.uv[:, 1].astype(f),
            curr.right_u.astype(f), curr.octave.astype(f),
            curr.valid.astype(f), z, z, z,
        ],
        axis=-1,
    )


def _best2_one(desc_a, attr_a, desc_b, attr_b, mode, check_ur=False):
    """ops.best2 on a single (row set, column set) pair."""
    outs = best2(desc_a[None], attr_a[None], desc_b[None], attr_b[None],
                 mode, check_ur)
    return [tuple(x[0] for x in o) for o in outs]


def _resolve_columns(idx, dist, row_ok, n_cols: int):
    """Per-column unique assignment from per-row best candidates.

    Same semantics as ``resolve_unique`` (smallest distance wins a
    contested keypoint, ties to the smaller row index) but from the
    kernel's per-row (idx, dist) vectors instead of an (M, N) matrix.
    Returns (assign (N,) int32 row index or -1, dist (N,)).
    """
    M = idx.shape[0]
    ok = row_ok & (idx >= 0)
    big = jnp.int32(INVALID_DIST * 16384)
    key = jnp.where(ok, dist * M + jnp.arange(M, dtype=jnp.int32), big)
    col = jnp.where(ok, idx, n_cols)  # out-of-range scatters drop
    colmin = jnp.full((n_cols,), big, jnp.int32).at[col].min(key)
    hit = colmin < big
    return (
        jnp.where(hit, colmin % M, -1),
        jnp.where(hit, colmin // M, INVALID_DIST),
    )


class ProjectedSources(NamedTuple):
    """Landmarks projected into the current frame, ready to match."""

    uv: jax.Array  # (M,2) predicted pixel coords
    ur: jax.Array  # (M,) predicted right-x (-1 if n/a)
    depth: jax.Array  # (M,) camera-frame z
    dist: jax.Array  # (M,) distance to camera center
    valid: jax.Array  # (M,) bool (in front, in image)


def project_sources(
    cam: CameraIntrinsics, T_cw: jax.Array, p_w: jax.Array, valid: jax.Array,
    border: float = 0.0,
) -> ProjectedSources:
    pc = p_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    zs = jnp.maximum(z, 1e-6)
    u = cam.fx * pc[:, 0] / zs + cam.cx
    v = cam.fy * pc[:, 1] / zs + cam.cy
    ur = u - cam.bf / zs
    ok = (
        valid
        & (z > 0.05)
        & (u >= border)
        & (u < cam.width - border)
        & (v >= border)
        & (v < cam.height - border)
    )
    dist = jnp.linalg.norm(pc, axis=-1)
    return ProjectedSources(jnp.stack([u, v], -1), ur, z, dist, ok)


def window_mask(
    proj_uv: jax.Array, curr_uv: jax.Array, radius: jax.Array
) -> jax.Array:
    """(M, N) mask: current keypoint j inside the square window of source m
    (the grid area query of frame.cpp:337-361 as a dense test)."""
    du = jnp.abs(curr_uv[None, :, 0] - proj_uv[:, None, 0])
    dv = jnp.abs(curr_uv[None, :, 1] - proj_uv[:, None, 1])
    r = radius[:, None]
    return (du <= r) & (dv <= r)


def resolve_unique(pair_dist: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Per-row best -> per-column unique assignment.

    Given (M, N) distances where each row m has at most its chosen
    candidates finite, returns (assign (N,) int32 source index or -1,
    dist (N,)).  Ties go to the smaller distance — a strict improvement
    over the reference's last-writer-wins overwrite.
    """
    best_j = jnp.argmin(pair_dist, axis=1)  # (M,)
    best_d = jnp.take_along_axis(pair_dist, best_j[:, None], axis=1)[:, 0]
    m_idx = jnp.arange(pair_dist.shape[0])
    only_best = jnp.full_like(pair_dist, INVALID_DIST).at[m_idx, best_j].set(best_d)
    assign_m = jnp.argmin(only_best, axis=0)  # (N,)
    assign_d = jnp.take_along_axis(only_best, assign_m[None, :], axis=0)[0]
    ok = assign_d < INVALID_DIST
    return jnp.where(ok, assign_m, -1), assign_d


def search_by_projection(
    curr: FrameFeatures,
    src_desc: jax.Array,
    proj: ProjectedSources,
    radius: jax.Array,
    oct_lo: jax.Array,
    oct_hi: jax.Array,
    max_dist: int = TH_HIGH,
    ratio: Optional[float] = None,
    src_angle: Optional[jax.Array] = None,
    check_ur: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Generic projection-window search.

    Covers the cores of searchByProjectionInLastAndCurrentFrame
    (src/orbMatcher.cpp:65-155), ...InFrameAndMapPoint (:24-64) and
    ...InKeyFrameAndCurrentFrame (:156-239): window + octave gates, best
    (and optional ratio) per source, then unique per-keypoint
    resolution, then optional rotation-consistency histogram.

    Returns (assign (N,) source index per current keypoint or -1,
    dist (N,)).
    """
    pm = window_mask(proj.uv, curr.uv, radius)
    pm &= (curr.octave[None, :] >= oct_lo[:, None]) & (
        curr.octave[None, :] <= oct_hi[:, None]
    )
    if check_ur:
        # Stereo coherence: |ur_curr - ur_proj| <= radius when the current
        # keypoint has a stereo measurement (orbMatcher.cpp:101-110).
        has_r = curr.right_u[None, :] >= 0
        ur_ok = jnp.abs(curr.right_u[None, :] - proj.ur[:, None]) <= radius[:, None]
        pm &= jnp.where(has_r, ur_ok, True)
    d = masked_distance_matrix(src_desc, curr.desc, proj.valid, curr.valid, pm)
    if ratio is not None:
        vals, _ = jax.lax.top_k(-d, 2)
        b1, b2 = -vals[:, 0], -vals[:, 1]
        row_ok = b1.astype(jnp.float32) < ratio * b2.astype(jnp.float32)
        d = jnp.where(row_ok[:, None], d, INVALID_DIST)
    d = jnp.where(d <= max_dist, d, INVALID_DIST)
    assign, dist = resolve_unique(d)
    if src_angle is not None:
        matched = assign >= 0
        ang_src = src_angle[jnp.clip(assign, 0, src_angle.shape[0] - 1)]
        keep = rotation_histogram_mask(curr.angle, ang_src, matched)
        assign = jnp.where(keep, assign, -1)
    return assign, dist


@functools.partial(jax.jit, static_argnames=("n_levels", "scale_factor", "th"))
def match_motion_model(
    cam: CameraIntrinsics,
    curr: FrameFeatures,
    last: FrameFeatures,
    last_landmarks_w: jax.Array,
    last_lm_valid: jax.Array,
    T_cw_pred: jax.Array,
    T_cw_last: jax.Array,
    th: float = 7.0,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> Tuple[jax.Array, jax.Array]:
    """Last-frame -> current-frame projection match (motion model).

    Vectorizes src/orbMatcher.cpp:65-155 including the forward/backward
    octave logic: if the camera advanced more than a baseline, current
    octaves must be >= the last keypoint's octave; if it backed up, <=;
    otherwise within +-1.  Radius = th * scale_factor^octave_last.
    Rotation histogram applied.  Returns per-current-keypoint index into
    the last frame (-1 = unmatched).
    """
    scales = scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)
    proj = project_sources(cam, T_cw_pred, last_landmarks_w, last_lm_valid)
    # Forward/backward decision from relative z translation (baseline units).
    T_rel = T_cw_pred @ inv_T(T_cw_last)
    tz = T_rel[2, 3]
    baseline = cam.bf / cam.fx
    forward = tz > baseline
    backward = tz < -baseline
    o = last.octave
    oct_lo = jnp.where(forward, o, jnp.where(backward, 0, o - 1))
    oct_hi = jnp.where(forward, n_levels, jnp.where(backward, o, o + 1))
    radius = th * scales[last.octave]
    return search_by_projection(
        curr, last.desc, proj, radius, oct_lo, oct_hi,
        max_dist=TH_HIGH, ratio=None, src_angle=last.angle, check_ur=True,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_levels", "scale_factor", "th_narrow", "th_wide", "max_dist",
        "histo_bins",
    ),
)
def match_motion_model_two(
    cam: CameraIntrinsics,
    curr: FrameFeatures,
    last: FrameFeatures,
    last_landmarks_w: jax.Array,
    last_lm_valid: jax.Array,
    T_cw_pred: jax.Array,
    T_cw_last: jax.Array,
    th_narrow: float = 7.0,
    th_wide: float = 14.0,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    max_dist: int = TH_HIGH,
    histo_bins: int = 30,
) -> Tuple[jax.Array, jax.Array]:
    """Both window widths of the motion-model search from ONE Hamming
    matrix.

    The reference searches with th=7 and, when fewer than 20 matches
    come back, repeats the whole search with 2*th (tracking.cpp:450-460).
    The XOR+popcount matrix is by far the expensive part and the narrow
    window is a subset of the wide one, so this computes distances once
    under the wide gates and re-resolves under the narrow mask.

    Returns (assign_narrow, assign_wide), each (N,) int32 into last.
    """
    scales = scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)
    proj = project_sources(cam, T_cw_pred, last_landmarks_w, last_lm_valid)
    T_rel = T_cw_pred @ inv_T(T_cw_last)
    tz = T_rel[2, 3]
    baseline = cam.bf / cam.fx
    forward = tz > baseline
    backward = tz < -baseline
    o = last.octave
    oct_lo = jnp.where(forward, o, jnp.where(backward, 0, o - 1))
    oct_hi = jnp.where(forward, n_levels, jnp.where(backward, o, o + 1))
    r_narrow = (th_narrow * scales[last.octave])[:, None]
    r_wide = (th_wide * scales[last.octave])[:, None]

    attr_a = _pack_src_attr(
        proj.uv[:, 0], proj.uv[:, 1], proj.ur,
        r_narrow[:, 0], r_wide[:, 0], oct_lo, oct_hi, proj.valid,
    )
    (i_n, bn, _), (i_w, bw, _) = _best2_one(
        last.desc, attr_a, curr.desc, _pack_cur_attr(curr), "window2",
        check_ur=True,
    )
    N = curr.valid.shape[0]

    def finish(idx, b1):
        assign, _ = _resolve_columns(idx, b1, b1 <= max_dist, N)
        matched = assign >= 0
        ang_src = last.angle[jnp.clip(assign, 0, last.angle.shape[0] - 1)]
        keep = rotation_histogram_mask(
            curr.angle, ang_src, matched, n_bins=histo_bins
        )
        return jnp.where(keep, assign, -1)

    return finish(i_n, bn), finish(i_w, bw)


def predict_scale_level(
    dist: jax.Array, max_dist: jax.Array, n_levels: int, scale_factor: float
) -> jax.Array:
    """MapPoint::predictScaleLevel (src/mapPoint.cpp:251-278):
    level = ceil(log(max_dist / dist) / log(scale_factor)), clamped."""
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-6), 1e-6)
    lvl = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor)).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_levels", "scale_factor", "th", "ratio", "max_dist",
        "return_visible",
    ),
)
def match_local_points(
    cam: CameraIntrinsics,
    curr: FrameFeatures,
    T_cw: jax.Array,
    mp_pos: jax.Array,
    mp_desc: jax.Array,
    mp_normal: jax.Array,
    mp_max_dist: jax.Array,
    mp_min_dist: jax.Array,
    mp_valid: jax.Array,
    th: float = 1.0,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    ratio: float = 0.8,
    max_dist: int = TH_HIGH,
    return_visible: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Local-map-point -> frame search (track-local-map).

    Fuses ``Frame::isInCameraFrustum`` (src/frame.cpp:295-326: in-image,
    scale-invariance distance band [0.8 min, 1.2 max], view cos > 0.5)
    with ``searchByProjectionInFrameAndMapPoint``
    (src/orbMatcher.cpp:24-64: radius 2.5 if view cos > 0.998 else 4.0,
    times th and the predicted octave's scale; octaves in
    [pred-1, pred]; ratio 0.8 between best/second).  The reference
    applies the ratio only when best and second share an octave; we
    apply it unconditionally (stricter, noted deviation).

    Returns per-current-keypoint map-point slot index (-1 = none).
    """
    scales = scale_factor ** jnp.arange(n_levels, dtype=jnp.float32)
    proj = project_sources(cam, T_cw, mp_pos, mp_valid)
    cam_center = -T_cw[:3, :3].T @ T_cw[:3, 3]
    po = mp_pos - cam_center[None]
    dist = jnp.linalg.norm(po, axis=-1)
    view_cos = jnp.sum(po * mp_normal, axis=-1) / jnp.maximum(
        dist * jnp.linalg.norm(mp_normal, axis=-1), 1e-6
    )
    band_ok = (dist >= 0.8 * mp_min_dist) & (dist <= 1.2 * mp_max_dist)
    frustum_ok = proj.valid & band_ok & (view_cos > 0.5)
    pred = predict_scale_level(dist, 1.2 * mp_max_dist, n_levels, scale_factor)
    radius = jnp.where(view_cos > 0.998, 2.5, 4.0) * scales[pred] * th
    proj = proj._replace(valid=frustum_ok)
    attr_a = _pack_src_attr(
        proj.uv[:, 0], proj.uv[:, 1], proj.ur, radius, radius,
        pred - 1, pred, proj.valid,
    )
    ((idx, b1, b2),) = _best2_one(
        mp_desc, attr_a, curr.desc, _pack_cur_attr(curr), "window",
    )
    row_ok = (b1 <= max_dist) & (
        b1.astype(jnp.float32) < ratio * b2.astype(jnp.float32)
    )
    res = _resolve_columns(idx, b1, row_ok, curr.valid.shape[0])
    return (*res, frustum_ok) if return_visible else res


@jax.jit
def match_dense(
    desc_a: jax.Array,
    valid_a: jax.Array,
    angle_a: jax.Array,
    desc_b: jax.Array,
    valid_b: jax.Array,
    angle_b: jax.Array,
    max_dist: int = TH_LOW,
    ratio: float = 0.7,
    use_rotation: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Appearance-only matching between two descriptor sets.

    Replaces the BoW-bucketed brute force of searchByBowInKeyFrameAndFrame
    / ...InTwoKeyFrames (src/orbMatcher.cpp:303-462): the vocabulary
    bucketing existed to prune CPU work; the full dense search is one
    batched pass and strictly higher recall.  Keeps the TH_LOW=50
    gate, best/second ratio and rotation histogram.

    Returns (assign (B,) index into a per b-keypoint or -1, dist (B,)).
    """
    # No geometric gate: an unbounded window and octave range.
    f = jnp.float32
    M, B = desc_a.shape[0], desc_b.shape[0]
    za, zb = jnp.zeros((M,), f), jnp.zeros((B,), f)
    wide = jnp.full((M,), 1e9, f)
    attr_a = _pack_src_attr(
        za, za, za, wide, wide, jnp.full((M,), -1.0, f), wide, valid_a,
    )
    attr_b = jnp.stack(
        [zb, zb, zb - 1.0, zb, valid_b.astype(f), zb, zb, zb], axis=-1
    )
    ((idx, b1, b2),) = _best2_one(desc_a, attr_a, desc_b, attr_b, "window")
    # A row with a single candidate has second-best = INVALID_DIST, which
    # would make the ratio test vacuous; clamp to 256 — the reference's
    # bestDist2 initialization (orbMatcher.cpp:318) — so a lone candidate
    # faces the same gate it would there.
    b2 = jnp.minimum(b2, 256)
    row_ok = (b1 <= max_dist) & (b1.astype(f) < ratio * b2.astype(f))
    assign, dist = _resolve_columns(idx, b1, row_ok, B)
    matched = assign >= 0
    ang_a = angle_a[jnp.clip(assign, 0, angle_a.shape[0] - 1)]
    keep = jnp.where(
        use_rotation,
        rotation_histogram_mask(angle_b, ang_a, matched),
        matched,
    )
    return jnp.where(keep, assign, -1), dist
