"""Absolute pose from 2D-3D correspondences: batched DLT-PnP RANSAC.

Replaces ``PnPsolver`` (src/pnpSolver.cpp): the reference wraps EPnP
(4 control points, barycentric 12x12 SVD, beta cases + Gauss-Newton)
in a sequential adaptive RANSAC.  Batched redesign (documented
deviation): minimal sets of 6 points solved by the direct linear
transform on NORMALIZED image coordinates — one (12, 12) SVD per
hypothesis, vmapped over the whole hypothesis budget at once — followed
by SO(3) projection (SVD orthonormalization) and the same per-octave
chi-square inlier gate (pnpSolver.hpp:100-101).  A 6-point DLT inside a
256-hypothesis batch is more robust per-FLOP in a vmapped batch than
EPnP's branchy beta cases, and the final accuracy comes from the pose-only LM
refinement that follows (reference does the same, tracking.cpp:693).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics

MIN_SET = 6


def _dlt_pose(p_w: jax.Array, xn: jax.Array) -> jax.Array:
    """(6,3) world points + (6,2) normalized image coords -> (4,4) T_cw.

    Rows of A: for each point, the two cross-product constraints of
    x_n ~ [R|t] X.  The 12-vector null space is reshaped to [R|t] and
    projected to SE(3).
    """
    n = p_w.shape[0]
    X = jnp.concatenate([p_w, jnp.ones((n, 1))], axis=-1)  # (6,4)
    zeros = jnp.zeros((n, 4))
    r1 = jnp.concatenate([X, zeros, -xn[:, 0:1] * X], axis=-1)
    r2 = jnp.concatenate([zeros, X, -xn[:, 1:2] * X], axis=-1)
    A = jnp.concatenate([r1, r2], axis=0)  # (12,12)
    _, _, vt = jnp.linalg.svd(A)
    P = vt[-1].reshape(3, 4)
    R_raw = P[:, :3]
    # Scale so that R has unit determinant; fix sign with point depths.
    U, s, Vt = jnp.linalg.svd(R_raw)
    R = U @ Vt
    det = jnp.linalg.det(R)
    R = R * jnp.sign(det)
    scale = jnp.sum(s) / 3.0 * jnp.sign(det)
    t = P[:, 3] / jnp.where(jnp.abs(scale) > 1e-9, scale, 1e-9)
    # Resolve the global sign: points must be in front of the camera.
    z = p_w @ R[2, :] + t[2]
    flip = jnp.sum(jnp.sign(z)) < 0
    R = jnp.where(flip, -R, R)
    t = jnp.where(flip, -t, t)
    # Re-orthonormalize after the possible flip (det must stay +1).
    U2, _, Vt2 = jnp.linalg.svd(R)
    D = jnp.diag(jnp.array([1.0, 1.0, jnp.linalg.det(U2 @ Vt2)]))
    R = U2 @ D @ Vt2
    T = jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t)
    return T


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "min_inliers"))
def ransac_pose_3d3d(
    key: jax.Array,
    cam: CameraIntrinsics,
    p_w: jax.Array,  # (N,3) map points (world)
    p_cam: jax.Array,  # (N,3) frame points from depth backprojection
    uv: jax.Array,  # (N,2) frame observations
    sigma2: jax.Array,
    has_depth: jax.Array,  # (N,) depth available (eligible for minimal sets)
    valid: jax.Array,
    n_hypotheses: int = 256,
    min_inliers: int = 10,
    chi2: float = 5.991,
) -> "PnPResult":
    """Pose RANSAC from 3-point Horn SE3 alignment of 3D-3D pairs.

    Stereo/RGB-D frames measure depth for most keypoints, so absolute
    pose needs only 3-point rigid alignment (p_cam = T_cw p_w) — a far
    smaller minimal set than PnP, which matters at low inlier ratios
    (0.35^3 vs 0.35^6 all-inlier probability).  Inliers are still scored
    by REPROJECTION (the reference's chi-square gate), so depth-less
    keypoints participate in scoring and refinement.  This is the
    primary relocalization solver; the reference's EPnP corresponds to
    the mono-only information case it never actually has
    (src/pnpSolver.cpp is only called from relocalization with
    stereo/RGB-D frames).
    """
    from .horn import horn_sim3

    n = p_w.shape[0]
    elig = valid & has_depth
    probs = elig.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-6)
    picks = jax.random.choice(
        key, n, shape=(n_hypotheses, 3), replace=True, p=probs
    )
    T_batch = jax.vmap(
        lambda pk: horn_sim3(p_cam[pk], p_w[pk], fix_scale=True)
    )(picks)

    def count(T):
        pc = p_w @ T[:3, :3].T + T[:3, 3]
        z = jnp.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return valid & (pc[:, 2] > 0.05) & (e2 <= chi2 * sigma2)

    inl = jax.vmap(count)(T_batch)
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    # Refine with Horn on ALL inliers that have depth.
    ref_mask = inl[best] & has_depth
    w = ref_mask.astype(jnp.float32)[:, None]
    nw = jnp.maximum(jnp.sum(w), 3.0)
    c_cam = jnp.sum(p_cam * w, axis=0) / nw
    c_w = jnp.sum(p_w * w, axis=0) / nw
    T_fine = horn_sim3(
        (p_cam - c_cam) * w + c_cam, (p_w - c_w) * w + c_w, fix_scale=True
    )
    inl_fine = count(T_fine)
    use = jnp.sum(inl_fine) >= counts[best]
    T_out = jnp.where(use, T_fine, T_batch[best])
    inl_out = jnp.where(use, inl_fine, inl[best])
    n_out = jnp.sum(inl_out)
    return PnPResult(
        T_cw=T_out, inliers=inl_out, n_inliers=n_out, ok=n_out >= min_inliers
    )


class PnPResult(NamedTuple):
    T_cw: jax.Array
    inliers: jax.Array
    n_inliers: jax.Array
    ok: jax.Array


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "min_inliers"))
def ransac_pnp(
    key: jax.Array,
    cam: CameraIntrinsics,
    p_w: jax.Array,  # (N,3)
    uv: jax.Array,  # (N,2) undistorted pixels
    sigma2: jax.Array,  # (N,) octave variance
    valid: jax.Array,  # (N,)
    n_hypotheses: int = 256,
    min_inliers: int = 10,
    chi2: float = 5.991,
) -> PnPResult:
    """Vmapped-hypothesis RANSAC with the reference's per-octave
    chi-square gate (pnpSolver params 0.99/10/300/4/0.5/5.991,
    tracking.cpp:657-658; the 300 sequential iterations become one
    batch)."""
    n = p_w.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-6)
    picks = jax.random.choice(
        key, n, shape=(n_hypotheses, MIN_SET), replace=True, p=probs
    )
    xn = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], axis=-1
    )
    T_batch = jax.vmap(lambda pk: _dlt_pose(p_w[pk], xn[pk]))(picks)

    def count(T):
        pc = p_w @ T[:3, :3].T + T[:3, 3]
        z = jnp.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return valid & (pc[:, 2] > 0.05) & (e2 <= chi2 * sigma2)

    inl = jax.vmap(count)(T_batch)
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    return PnPResult(
        T_cw=T_batch[best],
        inliers=inl[best],
        n_inliers=counts[best],
        ok=counts[best] >= min_inliers,
    )
