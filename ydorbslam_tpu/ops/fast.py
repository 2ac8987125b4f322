"""FAST-9/16 corner detection as whole-image vectorized ops.

Replaces the reference's per-30px-cell ``cv::FAST`` loop with high→low
threshold fallback (src/orbExtractor.cpp:545-604).  This formulation
computes a dense *corner score map* once per pyramid level:

  score(p) = max over the 16 contiguous 9-arcs of min |I_i - I(p)|,
  signed per bright/dark branch

which equals the largest threshold t for which the segment test still
passes — so "corner at threshold t" is simply ``score >= t``.  The
reference's two-threshold-per-cell fallback then becomes a per-cell
select on the score map (no second detection pass), and OpenCV's
nonmaxSuppression=true becomes a 3x3 max-pool equality test.  Everything
is elementwise/reduction work on (16, H, W) planes, fused by XLA; no
data-dependent shapes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3 (the 16 FAST offsets, (dx, dy), standard order).
FAST_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9_16 segment length


def _shifted_stack(image: jax.Array) -> jax.Array:
    """(H, W) -> (16, H, W) where plane k is the image sampled at circle
    offset k (edge values replicated; borders are masked out anyway)."""
    h, w = image.shape
    padded = jnp.pad(image, 3, mode="edge")
    planes = [
        jax.lax.dynamic_slice(padded, (3 + dy, 3 + dx), (h, w))
        for (dx, dy) in FAST_OFFSETS
    ]
    return jnp.stack(planes, axis=0)


@jax.jit
def fast_score_map(image: jax.Array) -> jax.Array:
    """Dense FAST-9 corner score (max passing threshold), float32 (H, W).

    score >= t  <=>  the pixel passes the FAST segment test at
    threshold t (exclusive OpenCV semantics use |d| > t; we use >= on
    integer-valued images which differs by at most 1 count).
    """
    circle = _shifted_stack(image)  # (16,H,W)
    d = circle - image[None]
    # min over each contiguous 9-arc of d and of -d, cyclically.
    def arc_min(x):
        # min over rolls 0..8 — log-depth tree of elementwise minima.
        m = x
        m = jnp.minimum(m, jnp.roll(m, -1, axis=0))  # covers spans of 2
        m2 = jnp.minimum(m, jnp.roll(m, -2, axis=0))  # spans of 4
        m4 = jnp.minimum(m2, jnp.roll(m2, -4, axis=0))  # spans of 8
        return jnp.minimum(m4, jnp.roll(x, -8, axis=0))  # span 9

    bright = jnp.max(arc_min(d), axis=0)  # best over the 16 arc starts
    dark = jnp.max(arc_min(-d), axis=0)
    return jnp.maximum(jnp.maximum(bright, dark), 0.0)


@functools.partial(jax.jit, static_argnames=("border",))
def nms_and_border(score: jax.Array, border: int) -> jax.Array:
    """3x3 non-max suppression + border mask; returns suppressed scores.

    Matches OpenCV FAST nonmaxSuppression plus the reference's detection
    region [maxPadSize-3, dim-(maxPadSize-3)) = 16px margins
    (src/orbExtractor.cpp:550-553).
    """
    h, w = score.shape
    neighborhood = jnp.pad(score, 1, mode="constant", constant_values=-1.0)
    local_max = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            shifted = jax.lax.dynamic_slice(neighborhood, (1 + dy, 1 + dx), (h, w))
            local_max = jnp.maximum(local_max, shifted)
    is_peak = score >= local_max
    row = jnp.arange(h)[:, None]
    col = jnp.arange(w)[None, :]
    in_bounds = (
        (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    )
    return jnp.where(is_peak & in_bounds, score, 0.0)


@functools.partial(jax.jit, static_argnames=("cell", "th_high", "th_low"))
def two_threshold_mask(
    score: jax.Array, cell: int = 32, th_high: float = 20.0, th_low: float = 7.0
) -> jax.Array:
    """The reference's per-cell threshold fallback as a select.

    Each cell keeps score >= th_high if any pixel in it reaches th_high,
    else falls back to score >= th_low (src/orbExtractor.cpp:581-583).
    Returns scores with failing pixels zeroed.
    """
    h, w = score.shape
    ch, cw = -(-h // cell), -(-w // cell)
    padded = jnp.pad(score, ((0, ch * cell - h), (0, cw * cell - w)))
    cells = padded.reshape(ch, cell, cw, cell)
    cell_max = cells.max(axis=(1, 3))  # (ch, cw)
    th = jnp.where(cell_max >= th_high, th_high, th_low)
    th_full = jnp.repeat(jnp.repeat(th, cell, axis=0), cell, axis=1)[:h, :w]
    return jnp.where(score >= th_full, score, 0.0)


@jax.jit
def fast_subpixel_offsets(patches: jax.Array) -> jax.Array:
    """Sub-pixel corner refinement from raw keypoint patches.

    ``patches``: (K, P, P) image patches centered on detected corners
    (any integer dtype or float; P odd, P >= 9).  Recomputes the FAST-9
    score at the central 3x3 positions of each patch and fits a 1-D
    parabola per axis through the score peak; returns (K, 2) float32
    (dx, dy) offsets in [-0.5, 0.5] level-pixel units.

    The reference keeps OpenCV's integer FAST corners
    (src/orbExtractor.cpp:545-604); integer quantization puts a ~0.29 px
    RMS floor on every reprojection residual downstream.  Recovering the
    fractional peak costs one (16, K, 3, 3) elementwise pass over
    patches that are already in registers for orientation/BRIEF — a
    deliberate accuracy improvement over the reference, not a parity
    deviation (the score definition matches ``fast_score_map`` exactly).

    Offsets are zeroed (no refinement) when any of the 4-neighbor
    scores is zero (the segment test fails there — a parabola through a
    clipped zero would bias the peak) or the fit is not concave.
    """
    K, P, _ = patches.shape
    c = P // 2
    x = patches.astype(jnp.float32)
    ctr = jax.lax.dynamic_slice(x, (0, c - 1, c - 1), (K, 3, 3))
    planes = [
        jax.lax.dynamic_slice(x, (0, c - 1 + dy, c - 1 + dx), (K, 3, 3))
        for (dx, dy) in FAST_OFFSETS
    ]
    d = jnp.stack(planes, axis=0) - ctr[None]  # (16, K, 3, 3)

    def arc_min(v):
        m = jnp.minimum(v, jnp.roll(v, -1, axis=0))
        m2 = jnp.minimum(m, jnp.roll(m, -2, axis=0))
        m4 = jnp.minimum(m2, jnp.roll(m2, -4, axis=0))
        return jnp.minimum(m4, jnp.roll(v, -8, axis=0))

    s = jnp.maximum(
        jnp.maximum(
            jnp.max(arc_min(d), axis=0), jnp.max(arc_min(-d), axis=0)
        ),
        0.0,
    )  # (K, 3, 3) FAST scores around each corner

    def parabola(lo, cen, hi):
        denom = lo - 2.0 * cen + hi
        off = 0.5 * (lo - hi) / jnp.minimum(denom, -1e-6)
        return jnp.where(denom < 0.0, jnp.clip(off, -0.5, 0.5), 0.0)

    dx = parabola(s[:, 1, 0], s[:, 1, 1], s[:, 1, 2])
    dy = parabola(s[:, 0, 1], s[:, 1, 1], s[:, 2, 1])
    ok = (
        (s[:, 1, 0] > 0.0) & (s[:, 1, 2] > 0.0)
        & (s[:, 0, 1] > 0.0) & (s[:, 2, 1] > 0.0)
        # Center-is-max guard: the NMS peak was selected on the float32
        # score map, but these scores come from the uint8-rounded patch —
        # near plateaus the recomputed 3x3 center may not be the local
        # max, and a parabola around a non-peak saturates at the +-0.5
        # clip.  Fall back to the integer corner instead.
        & (s[:, 1, 1] >= s[:, 1, 0]) & (s[:, 1, 1] >= s[:, 1, 2])
        & (s[:, 1, 1] >= s[:, 0, 1]) & (s[:, 1, 1] >= s[:, 2, 1])
    )
    return jnp.where(ok[:, None], jnp.stack([dx, dy], axis=-1), 0.0)
