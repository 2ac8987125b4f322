"""Spatially-uniform keypoint selection from dense score maps.

Replaces the reference's quadtree redistribution
(``OrbExtractor::distributeQuadTree``, src/orbExtractor.cpp:455-544):
the quadtree's purpose is to keep at most ~1 feature per adaptive cell
while spending the per-level budget on the highest responses.  The
equivalent with static shapes:

  1. 3x3 NMS on the score map (done in fast.py),
  2. one winner per fixed 8x8 cell (a reshape + argmax reduction —
     spatial uniformity at finer granularity than the quadtree's leaves),
  3. global top-K over cell winners for the per-level budget
     (``jax.lax.top_k`` over ~5k cells, not ~300k pixels).

Per-level budgets follow the reference's geometric split
(src/orbExtractor.cpp:325-340): K_l ∝ (1/scale_factor)^l, remainder to
the coarsest level.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

CELL = 8  # selection cell in pixels (finer than the reference's 30px FAST cells)


def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Per-level keypoint budgets, geometric in 1/scale_factor."""
    q = 1.0 / scale_factor
    first = n_features * (1.0 - q) / (1.0 - q**n_levels)
    ks = [int(round(first * q**l)) for l in range(n_levels - 1)]
    ks.append(max(0, n_features - sum(ks)))
    return ks


@functools.partial(jax.jit, static_argnames=("k",))
def select_topk_cells(score: jax.Array, k: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Pick top-k spatially-spread keypoints from a suppressed score map.

    Returns (uv (k,2) float32 level coords, response (k,), valid (k,) bool).
    """
    h, w = score.shape
    ch, cw = -(-h // CELL), -(-w // CELL)
    padded = jnp.pad(score, ((0, ch * CELL - h), (0, cw * CELL - w)))
    cells = padded.reshape(ch, CELL, cw, CELL).transpose(0, 2, 1, 3).reshape(
        ch * cw, CELL * CELL
    )
    cell_best = cells.max(axis=1)  # (ch*cw,)
    cell_arg = cells.argmax(axis=1)
    top_vals, top_idx = jax.lax.top_k(cell_best, k)
    cell_y = top_idx // cw
    cell_x = top_idx % cw
    in_y = cell_arg[top_idx] // CELL
    in_x = cell_arg[top_idx] % CELL
    u = (cell_x * CELL + in_x).astype(jnp.float32)
    v = (cell_y * CELL + in_y).astype(jnp.float32)
    valid = top_vals > 0.0
    return jnp.stack([u, v], axis=-1), top_vals, valid
