"""Pose-only bundle adjustment (motion-only LM on SE3).

Replaces ``Optimizer::optimizePose`` (src/optimizer.cpp:358-501, g2o
VertexSE3Expmap + OnlyPose edges): 4 episodes x 10 LM iterations; after
each episode observations are re-classified inlier/outlier by raw chi2
(5.991 mono / 7.815 stereo); each episode restarts from the INITIAL
pose with the refined inlier set (the reference resets the vertex
estimate per episode); the Huber kernel is dropped from episode index 3
onward (reference ``if(epi==2) setRobustKernel(0)`` takes effect the
following episode).

Formulation: the per-observation algebra is fully FLAT — Jacobian
components are individual (N,) arrays and the 6x6 normal equations are
27 masked reductions stacked into one (N, 28) sum (the (N, 3, 6)
vmapped layout keeps 3- and 6-wide minor dimensions on every
elementwise op).  This runs inside the frame-rate hot path twice per frame
(motion + local-map tracking), so the LM loop also CARRIES the normal
equations of the current pose between iterations: one projection pass
per iteration instead of the naive two (the step pass at T equals the
previous iteration's cost pass at T_new).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import orthonormalize_T, se3_exp
from .residuals import huber_cost, huber_scale

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObservations(NamedTuple):
    """Fixed-capacity observation set for one frame."""

    p_w: jax.Array  # (N,3) world landmark positions
    obs_uvr: jax.Array  # (N,3) (uL,vL,uR) with uR ignored when not has_stereo
    inv_sigma2: jax.Array  # (N,) octave information weight
    has_stereo: jax.Array  # (N,) bool
    valid: jax.Array  # (N,) bool


def _flat_project(cam, T, p_w, obs_uvr):
    """Componentwise projection: returns dict of (N,) arrays."""
    R, t = T[:3, :3], T[:3, 3]
    X, Y, Z = p_w[:, 0], p_w[:, 1], p_w[:, 2]
    x = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z + t[0]
    y = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z + t[1]
    zr = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z + t[2]
    z = jnp.maximum(zr, 1e-6)
    iz = 1.0 / z
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    return dict(
        x=x, y=y, z=z, zr=zr, iz=iz,
        ru=obs_uvr[:, 0] - u, rv=obs_uvr[:, 1] - v, rr=obs_uvr[:, 2] - ur,
    )


def _chi2_flat(pr, wu, wv, wr):
    return pr["ru"] ** 2 * wu + pr["rv"] ** 2 * wv + pr["rr"] ** 2 * wr


_TRI = [(i, j) for i in range(6) for j in range(i, 6)]  # 21 upper entries


def _normal_equations_flat(cam, T, obs: PoseObservations, active, use_huber,
                           delta2):
    """One flat pass: (H (6,6), b (6,), robust cost ()).

    Identical math to the vmapped formulation (J = -d pred/d xi for
    left-multiplied twists, r = obs - pred), verified against it in
    tests/test_optim_pose.py.
    """
    pr = _flat_project(cam, T, obs.p_w, obs.obs_uvr)
    mask = (active & (pr["zr"] > 1e-3)).astype(jnp.float32)
    wu = obs.inv_sigma2 * mask
    wr = wu * obs.has_stereo.astype(jnp.float32)
    chi2 = _chi2_flat(pr, wu, wu, wr)
    cost = jnp.sum(jnp.where(use_huber, huber_cost(chi2, delta2), chi2))
    hub = jnp.where(use_huber, huber_scale(chi2, delta2), 1.0)
    wu_h, wr_h = wu * hub, wr * hub

    x, y, z, iz = pr["x"], pr["y"], pr["z"], pr["iz"]
    iz2 = iz * iz
    a = cam.fx * iz
    c3 = -cam.fx * x * iz2
    d = cam.fy * iz
    e = -cam.fy * y * iz2
    cr = c3 + cam.bf * iz2
    zero = jnp.zeros_like(a)
    Ju = (-a, zero, -c3, -c3 * y, -(a * z - c3 * x), a * y)
    Jv = (zero, -d, -e, -(-d * z + e * y), e * x, -d * x)
    Jr = (-a, zero, -cr, -cr * y, -(a * z - cr * x), a * y)

    # Whitened-Jacobian matmul: H = J J^T, b = J r as ONE (6, 3N) x
    # (3N, ·) contraction instead of 27 separately-stacked (N,)
    # reductions.  sqrt-weighting is algebraically identical to
    # the weighted products (w * x * y == (sqrt(w) x)(sqrt(w) y)).
    sw_u = jnp.sqrt(wu_h)
    sw_r = jnp.sqrt(wr_h)
    J = jnp.stack(
        [
            jnp.concatenate([Ju[i] * sw_u, Jv[i] * sw_u, Jr[i] * sw_r])
            for i in range(6)
        ]
    )  # (6, 3N)
    r_w = jnp.concatenate(
        [pr["ru"] * sw_u, pr["rv"] * sw_u, pr["rr"] * sw_r]
    )  # (3N,)
    H = jax.lax.dot(J, J.T, precision=jax.lax.Precision.HIGHEST)
    b = J @ r_w
    return H, b, cost


def _classify_flat(cam, T, obs: PoseObservations, delta2):
    pr = _flat_project(cam, T, obs.p_w, obs.obs_uvr)
    wu = obs.inv_sigma2
    wr = wu * obs.has_stereo.astype(jnp.float32)
    chi2 = _chi2_flat(pr, wu, wu, wr)
    return obs.valid & (chi2 <= delta2) & (pr["zr"] > 1e-3)


def _solve_spd6(A, b):
    """6x6 SPD solve as UNROLLED scalar Cholesky.

    ``jnp.linalg.solve`` lowers the 6x6 LU to a pivoting while-loop —
    at 80 solves per pose optimization the loop overhead dominates the
    whole LM.  H is SPD by construction (normal equations + positive
    damping), so LL^T with straight-line scalar arithmetic is exact and
    fuses into a handful of XLA ops."""
    a = [[A[i, j] for j in range(6)] for i in range(6)]
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = a[i][i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-12))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, 6):
            s2 = a[j][i]
            for k in range(i):
                s2 = s2 - L[j][k] * L[i][k]
            L[j][i] = s2 * inv_d
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def _lm_refine(cam, T0, obs: PoseObservations, active, iters, use_huber, delta2):
    """LM loop with adaptive damping, fixed iteration count.

    Carries (H, b, cost) of the CURRENT pose so each iteration does one
    projection pass (step from the carried system, evaluate at T_new,
    keep whichever pose won)."""

    def body(_, state):
        T, H, b, lam, cost = state
        damped = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(6)
        dx = -_solve_spd6(damped, b)
        T_new = se3_exp(dx) @ T
        H_new, b_new, cost_new = _normal_equations_flat(
            cam, T_new, obs, active, use_huber, delta2
        )
        accept = cost_new < cost
        T = jnp.where(accept, T_new, T)
        H = jnp.where(accept, H_new, H)
        b = jnp.where(accept, b_new, b)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7), jnp.minimum(lam * 4.0, 1e4))
        cost = jnp.where(accept, cost_new, cost)
        return T, H, b, lam, cost

    H0, b0, cost0 = _normal_equations_flat(
        cam, T0, obs, active, use_huber, delta2
    )
    # UNROLLED, not lax.fori_loop: each iteration is ~50 elementwise ops
    # on small (N,) arrays plus a 6x6 solve, so a device-side loop would
    # pay its per-iteration control overhead on almost no work, while
    # XLA fuses across unrolled iterations.  Compile time grows (80
    # inlined iterations per pose solve) but precompile absorbs it.
    state = (T0, H0, b0, jnp.float32(1e-3), cost0)
    for k in range(iters):
        state = body(k, state)
    return state[0]


@functools.partial(jax.jit, static_argnames=("episodes", "iters_per_episode"))
def optimize_pose(
    cam: CameraIntrinsics,
    T_cw_init: jax.Array,
    obs: PoseObservations,
    episodes: int = 4,
    iters_per_episode: int = 10,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """-> (T_cw (4,4), inlier mask (N,), n_inliers ()).

    Mirrors the reference's episode protocol exactly (see module
    docstring); the returned count is matches minus outliers
    (src/optimizer.cpp:499-501).
    """
    delta2 = jnp.where(obs.has_stereo, CHI2_STEREO, CHI2_MONO)
    inlier = obs.valid
    T = T_cw_init
    for epi in range(episodes):
        use_huber = jnp.asarray(epi < 3)
        T = _lm_refine(
            cam, T_cw_init, obs, inlier, iters_per_episode, use_huber, delta2
        )
        # Re-classify ALL valid observations by raw chi2 at the new pose.
        inlier = _classify_flat(cam, T, obs, delta2)
    # Keep the returned pose exactly rigid: downstream chains it through
    # the velocity feedback loop, where correlated f32 drift compounds
    # multiplicatively (see geometry.se3.orthonormalize_T).
    return orthonormalize_T(T), inlier, jnp.sum(inlier)
