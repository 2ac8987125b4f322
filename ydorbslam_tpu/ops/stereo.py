"""Stereo matching and RGB-D depth association for a frame.

Replaces ``Frame::computeStereoMatches`` (src/frame.cpp:362-472: row-banded
descriptor search + SAD subpixel refinement + parabola fit +
median-disparity outlier cut) and ``Frame::computeStereoFromRGBD``
(src/frame.cpp:212-222: depth lookup -> virtual right-x).

Formulation: the per-row candidate lists become a dense masked
(N, N) Hamming matrix (row band + octave + disparity-range masks); the
per-keypoint SAD slide becomes a batched (N, 11, 21) strip correlation
evaluated for all 8 octaves with a select — everything static-shaped,
one jitted program.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics
from .descriptors import extract_patches
from .extractor import FrameFeatures
from .hamming import masked_distance_matrix
from .pyramid import scale_factors

SAD_W = 5  # SAD half-window (reference w=5 -> 11x11, frame.cpp:417)
SAD_L = 5  # slide range +-5 (frame.cpp:421)
TH_HIGH = 100
_PAD = SAD_W + SAD_L + 2  # image pad for strip extraction


def fill_depth_from_rgbd(
    feats: FrameFeatures, depth_image: jax.Array, cam: CameraIntrinsics,
    depth_map_factor_applied: bool = True,
) -> FrameFeatures:
    """Fill (depth, right_u) from a registered depth map.

    Looks depth up at the RAW keypoint coords and derives the virtual
    right-image x from the UNDISTORTED x — exactly the reference's
    convention (src/frame.cpp:212-222).
    """
    h, w = depth_image.shape
    ui = jnp.clip(jnp.round(feats.uv_raw[:, 0]).astype(jnp.int32), 0, w - 1)
    vi = jnp.clip(jnp.round(feats.uv_raw[:, 1]).astype(jnp.int32), 0, h - 1)
    d = depth_image[vi, ui]
    ok = feats.valid & (d > 0.0)
    right_u = jnp.where(ok, feats.uv[:, 0] - cam.bf / jnp.maximum(d, 1e-6), -1.0)
    depth = jnp.where(ok, d, -1.0)
    return feats._replace(depth=depth, right_u=right_u)


def _sad_costs_at_level(
    img_l: jax.Array, img_r: jax.Array, uv_l: jax.Array, ur: jax.Array
) -> jax.Array:
    """(N, 2*SAD_L+1) SAD costs for all keypoints at one pyramid level.

    Center-normalized 11x11 windows (the reference subtracts the window
    center, src/frame.cpp:418-420,427-429) slid +-SAD_L around the
    descriptor-matched right x.
    """
    pl = jnp.pad(img_l, _PAD, mode="edge")
    pr = jnp.pad(img_r, _PAD, mode="edge")
    patches = extract_patches(pl, uv_l + _PAD, SAD_W)  # (N,11,11)
    patches = patches - patches[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
    strip_half = SAD_W + SAD_L
    uv_r = jnp.stack([ur, uv_l[:, 1]], axis=-1)
    strips = extract_patches(pr, uv_r + _PAD, strip_half)  # (N,2s+1,2s+1)
    strips = strips[:, SAD_L : SAD_L + 2 * SAD_W + 1, :]  # (N,11,21)
    offs = []
    for off in range(2 * SAD_L + 1):
        win = strips[:, :, off : off + 2 * SAD_W + 1]
        win = win - win[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
        offs.append(jnp.sum(jnp.abs(patches - win), axis=(1, 2)))
    return jnp.stack(offs, axis=-1)  # (N, 11)


@functools.partial(jax.jit, static_argnames=("n_levels", "scale_factor"))
def stereo_match(
    feats_l: FrameFeatures,
    feats_r: FrameFeatures,
    pyr_l: Tuple[jax.Array, ...],
    pyr_r: Tuple[jax.Array, ...],
    cam: CameraIntrinsics,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> FrameFeatures:
    """Rectified stereo association: fills (depth, right_u) of the left frame.

    Pipeline (mirrors src/frame.cpp:362-471 behaviorally):
      1. dense Hamming matrix masked by row band (+-2 sigma of the left
         octave), octave agreement (+-1) and disparity range [0, fx),
      2. best match per left keypoint, <= TH_HIGH,
      3. SAD subpixel slide at the left keypoint's octave + parabola fit,
      4. median(SAD)-based outlier rejection at 1.5*1.4*median.
    """
    scales = jnp.asarray(scale_factors(n_levels, scale_factor))
    ul, vl = feats_l.uv_raw[:, 0], feats_l.uv_raw[:, 1]
    ur_kp, vr_kp = feats_r.uv_raw[:, 0], feats_r.uv_raw[:, 1]
    sigma_l = scales[feats_l.octave]

    max_d = cam.fx  # min depth = baseline -> max disparity = fx (frame.cpp:365)
    band = 2.0 * sigma_l[:, None]
    row_ok = jnp.abs(vr_kp[None, :] - vl[:, None]) <= band
    oct_ok = jnp.abs(feats_r.octave[None, :] - feats_l.octave[:, None]) <= 1
    disp = ul[:, None] - ur_kp[None, :]
    disp_ok = (disp >= -2.0) & (disp <= max_d)
    d = masked_distance_matrix(
        feats_l.desc, feats_r.desc, feats_l.valid, feats_r.valid,
        row_ok & oct_ok & disp_ok,
    )
    best_j = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best_j[:, None], axis=1)[:, 0]
    cand_ok = best_d <= TH_HIGH

    # SAD subpixel at the left keypoint's octave.
    inv_s = 1.0 / sigma_l
    uv_scaled = feats_l.uv_raw * inv_s[:, None]
    ur0 = ur_kp[best_j] * inv_s
    costs = jnp.zeros((feats_l.n, 2 * SAD_L + 1), jnp.float32)
    for level in range(n_levels):
        c = _sad_costs_at_level(pyr_l[level], pyr_r[level], uv_scaled, ur0)
        costs = jnp.where((feats_l.octave == level)[:, None], c, costs)

    inc = jnp.argmin(costs, axis=1)
    inner = (inc >= 1) & (inc <= 2 * SAD_L - 1)
    incc = jnp.clip(inc, 1, 2 * SAD_L - 1)
    c0 = jnp.take_along_axis(costs, incc[:, None] - 1, axis=1)[:, 0]
    c1 = jnp.take_along_axis(costs, incc[:, None], axis=1)[:, 0]
    c2 = jnp.take_along_axis(costs, incc[:, None] + 1, axis=1)[:, 0]
    denom = jnp.maximum(2.0 * (c0 + c2 - 2.0 * c1), 1e-6)
    delta = (c0 - c2) / denom
    sub_ok = inner & (jnp.abs(delta) <= 1.0)

    # The SAD window is extracted at the ROUNDED level-scaled left x
    # (extract_patches centers on integers), so the matched right x
    # corresponds to that rounded center, not the keypoint's fractional
    # x; re-add the rounding residual or every octave>0 (and, with
    # sub-pixel corners, every) keypoint inherits a [-0.5, 0.5] px
    # level-scale disparity bias -> a bf/d^2-amplified depth bias.
    # (same residual on the right: the strip is centered at round(ur0))
    frac_u = uv_scaled[:, 0] - jnp.round(uv_scaled[:, 0])
    best_ur = (
        jnp.round(ur0) + (incc - SAD_L).astype(jnp.float32) + delta + frac_u
    ) * sigma_l
    disparity = feats_l.uv[:, 0] - (best_ur + (feats_l.uv[:, 0] - ul))
    # note: shift best_ur into undistorted space by the same undistortion
    # delta as the left keypoint (rectified stereo shares the row map).
    disparity = jnp.clip(disparity, -1.0, None)
    # Minimum disparity of 0.3px caps depth at ~3.3*fx baselines; the
    # near-zero disparities a dense matcher occasionally produces would
    # otherwise create points at astronomical depth that destabilize
    # float32 bundle adjustment (the reference's f64 g2o tolerates them
    # and culls later; we gate at the source).
    pos_ok = (disparity > 0.3) & (disparity < max_d)
    depth = jnp.where(pos_ok, cam.bf / jnp.maximum(disparity, 1e-6), -1.0)

    ok = feats_l.valid & cand_ok & sub_ok & pos_ok

    # Median outlier cut on SAD best costs (frame.cpp:452-470).
    best_cost = jnp.take_along_axis(costs, incc[:, None], axis=1)[:, 0]
    sorted_costs = jnp.sort(jnp.where(ok, best_cost, jnp.inf))
    n_ok = jnp.sum(ok)
    median = sorted_costs[jnp.clip(n_ok // 2, 0, feats_l.n - 1)]
    median = jnp.where(jnp.isfinite(median), median, 0.0)
    ok = ok & (best_cost <= 1.5 * 1.4 * median)

    return feats_l._replace(
        depth=jnp.where(ok, depth, -1.0),
        right_u=jnp.where(ok, feats_l.uv[:, 0] - disparity, -1.0),
    )
