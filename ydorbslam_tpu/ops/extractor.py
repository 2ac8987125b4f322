"""The ORB extraction pipeline: one fused jitted program per image shape.

Replaces ``OrbExtractor::extractAndCompute`` (src/orbExtractor.cpp:355-399)
— pyramid, per-level FAST with threshold fallback, spatial
redistribution, intensity-centroid orientation, Gaussian blur, steered
BRIEF — and ``Frame``'s post-processing (undistortion,
src/frame.cpp:193-211).

Shape contract: the output is a fixed-capacity
``FrameFeatures`` struct (N = padded n_features) with a validity mask.
Every downstream stage (matching, triangulation, BA) consumes these
dense masked arrays — nothing in the pipeline ever has a data-dependent
shape, so the whole frontend compiles once and stays on-chip.

The reference's 64x48 occupancy grid for O(1) area queries
(src/frame.hpp:136-139) is intentionally dropped: with N<=1024 dense
masked distance tests replace grid gather/scatter.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import CameraIntrinsics, undistort_points
from .descriptors import (
    HALF_PATCH,
    RAW_HALF,
    blur_patches,
    brief_from_patches,
    extract_patches,
    orientation_from_patches,
)
from .fast import (fast_score_map, fast_subpixel_offsets, nms_and_border,
                   two_threshold_mask)
from .pyramid import build_pyramid, scale_factors
from .select import level_budgets, select_topk_cells

DETECT_BORDER = 16  # reference maxPadSize-3 (src/orbExtractor.cpp:550-553)


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set (the JAX-side ``Frame``).

    All arrays have leading dim N (capacity); ``valid`` masks real rows.
    ``uv`` is undistorted level-0 pixel coords (the reference matches and
    optimizes in undistorted space, src/frame.cpp:193-211); ``uv_raw``
    keeps the detector coords for depth lookup (src/frame.cpp:212-222).
    ``right_u`` is the virtual right-image x (-1 when unavailable) and
    ``depth`` the metric depth (-1 when unavailable).
    """

    uv: jax.Array  # (N,2) f32
    uv_raw: jax.Array  # (N,2) f32
    response: jax.Array  # (N,) f32
    octave: jax.Array  # (N,) i32
    angle: jax.Array  # (N,) f32 radians
    desc: jax.Array  # (N,8) u32
    right_u: jax.Array  # (N,) f32
    depth: jax.Array  # (N,) f32
    valid: jax.Array  # (N,) bool

    @property
    def n(self):
        return self.uv.shape[0]


def empty_features(n: int) -> FrameFeatures:
    return FrameFeatures(
        uv=jnp.zeros((n, 2), jnp.float32),
        uv_raw=jnp.zeros((n, 2), jnp.float32),
        response=jnp.zeros((n,), jnp.float32),
        octave=jnp.zeros((n,), jnp.int32),
        angle=jnp.zeros((n,), jnp.float32),
        desc=jnp.zeros((n, 8), jnp.uint32),
        right_u=-jnp.ones((n,), jnp.float32),
        depth=-jnp.ones((n,), jnp.float32),
        valid=jnp.zeros((n,), bool),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_features", "capacity", "n_levels", "scale_factor",
        "th_high", "th_low", "has_distortion", "subpixel",
    ),
)
def extract_orb(
    image: jax.Array,
    cam: CameraIntrinsics,
    n_features: int = 1000,
    capacity: int = 1024,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    th_high: int = 20,
    th_low: int = 7,
    has_distortion: bool = True,
    subpixel: bool = True,
) -> FrameFeatures:
    """(H, W) image (uint8 or float32) -> FrameFeatures with capacity
    rows.  uint8 input is converted ON DEVICE — sensors deliver 8-bit
    gray, and shipping it raw through the host->device link is 4x less
    transfer than a host-side float32 conversion."""
    image = image.astype(jnp.float32)
    pyr = build_pyramid(image, n_levels, scale_factor)
    budgets = level_budgets(n_features, n_levels, scale_factor)
    scales = scale_factors(n_levels, scale_factor)

    uvs, patches_l = [], []
    resps, octs, valids = [], [], []
    for level in range(n_levels):
        lvl = pyr[level]
        k = budgets[level]
        if k == 0:
            continue
        score = nms_and_border(fast_score_map(lvl), DETECT_BORDER)
        score = two_threshold_mask(score, 32, float(th_high), float(th_low))
        uv_l, resp, valid = select_topk_cells(score, k)

        # ONE raw uint8 patch per keypoint feeds orientation, the
        # descriptor blur AND the BRIEF tests (gathers are byte-bound;
        # the reference's pyramid is uint8 anyway).
        lvl_u8 = jnp.clip(jnp.round(lvl), 0.0, 255.0).astype(jnp.uint8)
        pad = jnp.pad(lvl_u8, RAW_HALF, mode="edge")
        patch = extract_patches(pad, uv_l + RAW_HALF, RAW_HALF)
        patches_l.append(patch)

        # Sub-pixel corner refinement from the SAME raw patches (see
        # fast.fast_subpixel_offsets): integer FAST corners carry a
        # ~0.29 px RMS quantization floor into every downstream
        # residual; the parabola fit recovers the fractional peak for
        # the cost of one (16, k, 3, 3) elementwise pass.  Orientation/
        # BRIEF stay on the integer-centered patch (as in the
        # reference, which never re-samples either).
        if subpixel:
            uv_l = uv_l + fast_subpixel_offsets(patch)

        uvs.append(uv_l * scales[level])
        resps.append(resp)
        octs.append(jnp.full((k,), level, jnp.int32))
        valids.append(valid)

    uv_raw = jnp.concatenate(uvs, axis=0)
    response = jnp.concatenate(resps, axis=0)
    octave = jnp.concatenate(octs, axis=0)
    valid = jnp.concatenate(valids, axis=0)

    # Orientation (raw central 31x31), blur, BRIEF — fused across all
    # levels so the selection matmuls see one large batch.
    patches = jnp.concatenate(patches_l, axis=0).astype(jnp.float32)
    c0 = RAW_HALF - HALF_PATCH
    K_tot = patches.shape[0]
    ctr = jax.lax.dynamic_slice(
        patches, (0, c0, c0), (K_tot, 2 * HALF_PATCH + 1, 2 * HALF_PATCH + 1)
    )
    angle = orientation_from_patches(ctr)
    desc = brief_from_patches(blur_patches(patches), angle)

    pad = capacity - uv_raw.shape[0]
    if pad < 0:
        raise ValueError(f"capacity {capacity} < total budget {uv_raw.shape[0]}")
    if pad:
        uv_raw = jnp.pad(uv_raw, ((0, pad), (0, 0)))
        response = jnp.pad(response, (0, pad))
        octave = jnp.pad(octave, (0, pad))
        angle = jnp.pad(angle, (0, pad))
        desc = jnp.pad(desc, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, (0, pad))

    uv = undistort_points(cam, uv_raw) if has_distortion else uv_raw
    n = capacity
    return FrameFeatures(
        uv=jnp.where(valid[:, None], uv, 0.0),
        uv_raw=jnp.where(valid[:, None], uv_raw, 0.0),
        response=response,
        octave=octave,
        angle=angle,
        desc=desc,
        right_u=-jnp.ones((n,), jnp.float32),
        depth=-jnp.ones((n,), jnp.float32),
        valid=valid,
    )
