"""Image pyramid + Gaussian blur as matmuls.

Replaces the reference's ``OrbExtractor::computePyramid`` (OpenCV
``cv::resize`` INTER_LINEAR chained level-to-level plus reflected
borders, src/orbExtractor.cpp:605-621) and the pre-descriptor 7x7 sigma=2
``GaussianBlur`` (src/orbExtractor.cpp:386).

Bilinear resampling along an axis is a sparse linear map; we
materialize it as a dense (dst, src) matrix (two nonzeros per row) and
apply it as two float32 matmuls ``R @ img @ C^T`` — no gathers, and XLA
fuses the pair.  Separable Gaussian
blur is likewise two small matmuls with banded matrices.  All matrices
are baked as compile-time constants per level, so the whole pyramid is
one fused jitted program with static shapes.

Level geometry matches the reference: level l has size
``round(dim * scale_factor^-l)`` (computed from the ORIGINAL image size,
src/orbExtractor.cpp:608-609), resampled from level l-1.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _resize_matrix(dst: int, src: int) -> np.ndarray:
    """Dense (dst, src) bilinear resampling matrix, OpenCV INTER_LINEAR
    coordinate convention: src_x = (dst_x + 0.5) * src/dst - 0.5."""
    M = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for d in range(dst):
        x = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        w1 = x - x0
        x0c = min(max(x0, 0), src - 1)
        x1c = min(max(x0 + 1, 0), src - 1)
        M[d, x0c] += 1.0 - w1
        M[d, x1c] += w1
    return M


def _gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _blur_matrix(n: int, ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Banded (n, n) 1D Gaussian blur matrix with BORDER_REFLECT_101."""
    g = _gaussian_kernel_1d(ksize, sigma)
    r = ksize // 2
    M = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for k in range(-r, r + 1):
            j = i + k
            if j < 0:
                j = -j  # reflect101: -1 -> 1
            elif j >= n:
                j = 2 * (n - 1) - j
            M[i, j] += g[k + r]
    return M


def pyramid_shapes(
    height: int, width: int, n_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    """(H_l, W_l) per level, reference rounding (orbExtractor.cpp:608)."""
    out = []
    for level in range(n_levels):
        inv = scale_factor ** (-level)
        out.append((int(round(height * inv)), int(round(width * inv))))
    return out


@functools.partial(jax.jit, static_argnames=("n_levels", "scale_factor"))
def build_pyramid(
    image: jax.Array, n_levels: int = 8, scale_factor: float = 1.2
) -> Tuple[jax.Array, ...]:
    """float32 (H, W) image -> tuple of per-level images (chained resize).

    Returned as a tuple (static shapes differ per level).
    """
    h, w = image.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [image]
    for level in range(1, n_levels):
        ph, pw = shapes[level - 1]
        nh, nw = shapes[level]
        R = jnp.asarray(_resize_matrix(nh, ph))
        C = jnp.asarray(_resize_matrix(nw, pw))
        levels.append(R @ levels[-1] @ C.T)
    return tuple(levels)


@functools.partial(jax.jit, static_argnames=("ksize", "sigma"))
def gaussian_blur(image: jax.Array, ksize: int = 7, sigma: float = 2.0) -> jax.Array:
    """Separable Gaussian blur via two banded matmuls (reflect101 edges)."""
    h, w = image.shape
    By = jnp.asarray(_blur_matrix(h, ksize, sigma))
    Bx = jnp.asarray(_blur_matrix(w, ksize, sigma))
    return By @ image @ Bx.T


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level scale (level coords * scale = level-0 coords)."""
    return (scale_factor ** np.arange(n_levels)).astype(np.float32)


def level_sigma2(n_levels: int, scale_factor: float) -> np.ndarray:
    """Per-level variance used as information weights in optimization
    (reference inverse-sigma2, src/optimizer.cpp information setup)."""
    return (scale_factor ** (2.0 * np.arange(n_levels))).astype(np.float32)
