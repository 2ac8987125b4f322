"""Bundle adjustment via Levenberg-Marquardt with Schur complement.

Replaces g2o's sparse BA machinery — BlockSolver_6_3 with marginalized
point vertices + LinearSolverEigen + OptimizationAlgorithmLevenberg
(src/optimizer.cpp:7-357: bundleAdjust / localBundleAdjust /
globalBundleAdjust) — with an explicit, fully-batched implementation:

  * observations are grouped BY POINT into fixed (P, O) slots, which
    makes landmark marginalization a per-point 3x3 inverse (vmapped),
  * the reduced camera system S (6C x 6C) is assembled with one
    segment-sum over observation pairs and solved with dense Cholesky —
    for C <= a few hundred cameras this is small dense algebra and exact,
  * the LM loop is a fixed-iteration ``fori``-style Python loop with
    accept/reject damping; "edge outlier demotion" is a weight mask.

Gauge fixing: boolean ``cam_fixed`` rows get identity blocks in S
(reference fixes KF0 and all observer-only KFs,
src/optimizer.cpp:27,170-190).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import se3_exp
from .residuals import (
    chi2_per_obs,
    huber_cost,
    huber_scale,
    residual_and_jacobians,
)

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
_SCHUR_CHUNK = 1024  # point-chunk size for reduced-system assembly


class BAProblem(NamedTuple):
    """Point-grouped BA problem with static capacities C cameras,
    P points, O observations per point."""

    T_cw: jax.Array  # (C,4,4)
    cam_fixed: jax.Array  # (C,) bool — gauge/observer cameras
    cam_valid: jax.Array  # (C,) bool
    p_w: jax.Array  # (P,3)
    pt_valid: jax.Array  # (P,) bool
    obs_cam: jax.Array  # (P,O) i32 camera index or -1
    obs_uvr: jax.Array  # (P,O,3)
    obs_inv_sigma2: jax.Array  # (P,O)
    obs_stereo: jax.Array  # (P,O) bool
    obs_valid: jax.Array  # (P,O) bool

    @property
    def C(self):
        return self.T_cw.shape[0]

    @property
    def P(self):
        return self.p_w.shape[0]

    @property
    def O(self):
        return self.obs_cam.shape[0:2][1]


def inv3x3(M: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse (adjugate / det).

    ``jnp.linalg.inv`` on batches of tiny matrices lowers to a batched
    LU factorization; the cofactor formula is pure elementwise work that
    XLA fuses into its producers.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def inv6x6_blocked(M: jax.Array) -> jax.Array:
    """Closed-form batched 6x6 inverse via 2x2 block elimination of 3x3
    blocks (each inverted with the cofactor formula) — no batched LU.

        M = [[A, B], [C, D]],  S = D - C A^-1 B
        M^-1 = [[A^-1 + A^-1 B S^-1 C A^-1, -A^-1 B S^-1],
                [-S^-1 C A^-1,               S^-1]]
    """
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    Cb = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ B
    Sinv = inv3x3(D - Cb @ AinvB)
    CAinv = Cb @ Ainv
    top_left = Ainv + AinvB @ Sinv @ CAinv
    top_right = -AinvB @ Sinv
    bot_left = -Sinv @ CAinv
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bot = jnp.concatenate([bot_left, Sinv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _pcg_solve_blocks(S: jax.Array, b: jax.Array, iters: int = 128) -> jax.Array:
    """Solve S x = b for block-structured S (C,C,6,6), b (C,6) with
    BLOCK-Jacobi preconditioned conjugate gradients.

    Dense LU/Cholesky of the (6C, 6C) reduced system is a sequential
    panel factorization; PCG is pure matmul work.  The preconditioner
    must be the full 6x6 diagonal block — scalar Jacobi stagnates/diverges on real BA systems (pose blocks
    couple rotation and translation strongly).
    """
    C = S.shape[0]
    diag = S[jnp.arange(C), jnp.arange(C)]  # (C,6,6)
    Minv = inv6x6_blocked(diag + 1e-5 * jnp.eye(6))

    def matvec(x):
        return jnp.einsum("cdij,dj->ci", S, x)

    def precond(r):
        return jnp.einsum("cij,cj->ci", Minv, r)

    x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    z0 = precond(r0)

    def body(_, state):
        x, r, z, p, rz = state
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) > 1e-20, denom, 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) > 1e-20, rz, 1e-20)
        p = z + beta * p
        return x, r, z, p, rz_new

    x, _, _, _, _ = jax.lax.fori_loop(
        0, iters, body, (x0, r0, z0, z0, jnp.sum(r0 * z0))
    )
    return x


def _cholesky_solve_blocks(S: jax.Array, b: jax.Array) -> jax.Array:
    """Solve S x = b for block-structured S (C,C,6,6), b (C,6) by dense
    Cholesky of the (6C, 6C) system.

    One blocked Cholesky + triangular solves instead of a 48-iteration
    PCG loop whose every tiny matvec pays a loop step.  S is fully
    assembled (and psum-replicated in the sharded path) before
    the solve, so a direct factorization is legal in both paths; PCG
    (_pcg_solve_blocks) is kept for problems too large to factor."""
    C = S.shape[0]
    D = C * 6
    M = S.transpose(0, 2, 1, 3).reshape(D, D)
    L = jax.lax.linalg.cholesky(M)
    y = jax.lax.linalg.triangular_solve(
        L, b.reshape(D, 1), left_side=True, lower=True
    )
    x = jax.lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True
    )
    return x.reshape(C, 6)


def _per_obs(cam, T_all, p_w, prob: BAProblem):
    """Vmapped residuals/Jacobians over the (P,O) observation grid."""
    camc = jnp.clip(prob.obs_cam, 0, prob.C - 1)
    T_obs = T_all[camc]  # (P,O,4,4)

    def one(T, p, obs):
        return residual_and_jacobians(cam, T, p, obs)

    r, Jc, Jp, z = jax.vmap(jax.vmap(one, in_axes=(0, None, 0)))(
        T_obs, p_w, prob.obs_uvr
    )
    return r, Jc, Jp, z


def _weights(prob: BAProblem, z, active):
    w3 = jnp.broadcast_to(
        prob.obs_inv_sigma2[..., None], prob.obs_inv_sigma2.shape + (3,)
    )
    stereo_row = jnp.stack(
        [jnp.ones_like(prob.obs_stereo)] * 2 + [prob.obs_stereo], axis=-1
    )
    w3 = jnp.where(stereo_row, w3, 0.0)
    mask = (
        active
        & prob.obs_valid
        & (prob.obs_cam >= 0)
        & prob.pt_valid[:, None]
        & (z > 1e-3)
    )
    return w3 * mask[..., None].astype(jnp.float32), mask


def ba_cost_and_chi2(cam, T_all, p_w, prob: BAProblem, active, use_huber):
    r, _, _, z = _per_obs(cam, T_all, p_w, prob)
    w3, mask = _weights(prob, z, active)
    chi2 = chi2_per_obs(r, w3)
    delta2 = jnp.where(prob.obs_stereo, CHI2_STEREO, CHI2_MONO)
    cost = jnp.sum(
        jnp.where(use_huber, huber_cost(chi2, delta2), chi2)
        * mask.astype(jnp.float32)
    )
    return cost, chi2, mask


def _lm_iteration(cam, T_all, p_w, prob: BAProblem, active, lam, use_huber):
    """One damped step: returns (T_new, p_new)."""
    C, P, O = prob.C, prob.P, prob.obs_cam.shape[1]
    r, Jc, Jp, z = _per_obs(cam, T_all, p_w, prob)
    w3, mask = _weights(prob, z, active)
    delta2 = jnp.where(prob.obs_stereo, CHI2_STEREO, CHI2_MONO)
    chi2 = chi2_per_obs(r, w3)
    hub = jnp.where(use_huber, huber_scale(chi2, delta2), 1.0)
    w = w3 * hub[..., None]  # (P,O,3)

    # Per-point Hessian blocks and gradients.
    Hpp = jnp.einsum("poci,poc,pocj->pij", Jp, w, Jp)  # (P,3,3)
    bp = jnp.einsum("poci,poc,poc->pi", Jp, w, r)  # (P,3)
    Hpp_d = Hpp + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(Hpp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    )
    Hpp_inv = inv3x3(Hpp_d)
    fixed_pt = ~prob.pt_valid
    Hpp_inv = jnp.where(fixed_pt[:, None, None], 0.0, Hpp_inv)

    # --- one-hot assembly -----------------------------------------------
    # Every "accumulate into camera c" becomes a matmul against the one-hot
    # observation->camera incidence E (P,O,C).  This also eliminates the
    # reference-style (P,O,O) pair enumeration for the Schur term:
    #   U[p,c] = sum_o E[p,o,c] BHinv[p,o]   (6,3)
    #   V[p,c] = sum_o E[p,o,c] B[p,o]       (6,3)
    #   S_off  = sum_p U[p] V[p]^T           (C,C,6,6)  — one big matmul.
    camc = jnp.clip(prob.obs_cam, 0, C - 1)  # (P,O)
    E = (
        (camc[..., None] == jnp.arange(C)[None, None, :])
        & (prob.obs_cam >= 0)[..., None]
    ).astype(jnp.float32)  # (P,O,C)

    Hcc_blocks = jnp.einsum("poci,poc,pocj->poij", Jc, w, Jc)  # (P,O,6,6)
    Hcc = jnp.einsum("poc,poij->cij", E, Hcc_blocks)  # (C,6,6)
    bc = jnp.einsum(
        "poc,poi->ci", E, jnp.einsum("poci,poc,poc->poi", Jc, w, r)
    )  # (C,6)

    # Coupling B = Jc^T W Jp per obs: (P,O,6,3)
    B = jnp.einsum("poci,poc,pocj->poij", Jc, w, Jp)
    BHinv = jnp.einsum("poij,pjk->poik", B, Hpp_inv)  # (P,O,6,3)
    U = jnp.einsum("poc,poik->pcik", E, BHinv)  # (P,C,6,3)
    V = jnp.einsum("poc,pojk->pcjk", E, B)  # (P,C,6,3)
    Um = U.transpose(1, 2, 0, 3).reshape(C * 6, P * 3)
    Vm = V.transpose(1, 2, 0, 3).reshape(C * 6, P * 3)
    S_off = (Um @ Vm.T).reshape(C, 6, C, 6).transpose(0, 2, 1, 3)

    # Reduced rhs: bs = bc - sum_p U_p bp_p
    bs = bc - jnp.einsum("pcik,pk->ci", U, bp)  # (C,6)

    # Assemble dense S with damping on camera diagonal.
    Hcc_d = Hcc + lam * jnp.eye(6) * jnp.maximum(
        jnp.trace(Hcc, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
    )
    S = -S_off
    S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc_d)
    # Gauge: fixed/invalid cameras get identity rows/cols and zero rhs.
    free = prob.cam_valid & ~prob.cam_fixed
    fmask = free.astype(jnp.float32)
    S = S * fmask[:, None, None, None] * fmask[None, :, None, None]
    S = S.at[jnp.arange(C), jnp.arange(C)].add(
        jnp.where(free, 0.0, 1.0)[:, None, None] * jnp.eye(6)
    )
    bs = bs * fmask[:, None]

    dxc = -_pcg_solve_blocks(S, bs)
    # Sanitize: a breakdown in f32 CG (division by a tiny curvature) must
    # not poison the state — the LM accept/reject can only veto steps
    # whose COST is comparable, not NaN.
    dxc = jnp.where(jnp.isfinite(dxc), dxc, 0.0)
    dxc_norm = jnp.linalg.norm(dxc, axis=-1, keepdims=True)
    dxc = jnp.where(dxc_norm < 1e3, dxc, 0.0)

    # Back-substitute points: dxp = -Hpp^-1 (bp + sum_o B_o^T dxc[cam_o])
    dxc_obs = dxc[camc]  # (P,O,6)
    corr = jnp.einsum("poij,poi->pj", B, dxc_obs)  # (P,3)
    dxp = -jnp.einsum("pij,pj->pi", Hpp_inv, bp + corr)
    # Trust-region guard: near-singular landmark Hessians (e.g. a single
    # far observation) can produce astronomical steps whose cost overflows
    # float32 into inf/NaN before the accept/reject test can veto them.
    dxp = jnp.where(jnp.isfinite(dxp), dxp, 0.0)
    dxp_norm = jnp.linalg.norm(dxp, axis=-1, keepdims=True)
    dxp = jnp.where(dxp_norm < 1e3, dxp, 0.0)

    T_new = jax.vmap(lambda d, T: se3_exp(d) @ T)(dxc, T_all)
    T_new = jnp.where(free[:, None, None], T_new, T_all)
    p_new = jnp.where(prob.pt_valid[:, None], p_w + dxp, p_w)
    return T_new, p_new


# ---------------------------------------------------------------------
# Flat (lane-major) LM path.
#
# The vmapped formulation above keeps per-observation tensors shaped
# (P, O, 3, 6) — the minor dimensions are 3/6 on every elementwise op.
# The production path
# below flattens observations to Q = P*O and unrolls the small-matrix
# algebra into individual (Q,) component arrays: all elementwise work is
# lane-dense, the camera reduction is ONE (C, Q) @ (Q, 42) matmul
# against the one-hot incidence built once per solve, and only the
# point-batched Schur coupling keeps an einsum.  Numerically identical
# to _lm_iteration (same order of operations per component).
# ---------------------------------------------------------------------


def _po_flat(a: jax.Array) -> jax.Array:
    """(P, O, ...) -> (Q, ...) in O-MAJOR order (q = o * P + p).

    O-major makes every per-point reduction a contiguous
    ``reshape(O, P) -> sum(axis=0)``: a reduction over the major axis
    with P contiguous in memory, instead of reducing short (P, O) rows
    with O=16 minor."""
    return jnp.swapaxes(a, 0, 1).reshape((-1,) + a.shape[2:])


def _po_unflat(q: jax.Array, P: int, O: int) -> jax.Array:
    """(Q, ...) o-major -> (P, O, ...)."""
    return jnp.swapaxes(q.reshape((O, P) + q.shape[1:]), 0, 1)


class _FlatObs(NamedTuple):
    """Loop-invariant flattened observation data (Q = P*O, o-major)."""

    cam_idx: jax.Array  # (Q,) clipped camera index
    p_idx: jax.Array  # (Q,) point index
    obs_u: jax.Array  # (Q,)
    obs_v: jax.Array  # (Q,)
    obs_r: jax.Array  # (Q,)
    inv_s2: jax.Array  # (Q,)
    stereo: jax.Array  # (Q,) bool
    base_ok: jax.Array  # (Q,) bool: obs_valid & cam>=0 & pt_valid
    E: jax.Array  # (Q, C) one-hot obs->camera incidence (f32)


def _flatten_obs(prob: BAProblem) -> _FlatObs:
    C, P, O = prob.C, prob.P, prob.obs_cam.shape[1]
    cam_f = _po_flat(prob.obs_cam)
    camc = jnp.clip(cam_f, 0, C - 1)
    ok = (cam_f >= 0) & _po_flat(prob.obs_valid) & jnp.tile(
        prob.pt_valid, O
    )
    E = (
        (camc[:, None] == jnp.arange(C)[None, :]) & ok[:, None]
    ).astype(jnp.float32)
    uvr = _po_flat(prob.obs_uvr)
    return _FlatObs(
        cam_idx=camc,
        p_idx=jnp.tile(jnp.arange(P, dtype=jnp.int32), O),
        obs_u=uvr[:, 0],
        obs_v=uvr[:, 1],
        obs_r=uvr[:, 2],
        inv_s2=_po_flat(prob.obs_inv_sigma2),
        stereo=_po_flat(prob.obs_stereo),
        base_ok=ok,
        E=E,
    )


def _flat_project(cam, T_all, p_w, f: _FlatObs):
    """Componentwise projection at every observation.

    Returns dict of (Q,) arrays: camera-frame point, residuals, R rows.
    """
    Tf = T_all.reshape(T_all.shape[0], 16)[f.cam_idx]  # (Q,16) row gather
    R00, R01, R02, t0 = Tf[:, 0], Tf[:, 1], Tf[:, 2], Tf[:, 3]
    R10, R11, R12, t1 = Tf[:, 4], Tf[:, 5], Tf[:, 6], Tf[:, 7]
    R20, R21, R22, t2 = Tf[:, 8], Tf[:, 9], Tf[:, 10], Tf[:, 11]
    pw = p_w[f.p_idx]  # (Q,3)
    X, Y, Z = pw[:, 0], pw[:, 1], pw[:, 2]
    x = R00 * X + R01 * Y + R02 * Z + t0
    y = R10 * X + R11 * Y + R12 * Z + t1
    zr = R20 * X + R21 * Y + R22 * Z + t2
    z = jnp.maximum(zr, 1e-6)
    iz = 1.0 / z
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    return dict(
        x=x, y=y, z=z, zr=zr, iz=iz,
        ru=f.obs_u - u, rv=f.obs_v - v, rr=f.obs_r - ur,
        R=(R00, R01, R02, R10, R11, R12, R20, R21, R22),
    )


def _flat_weights(f: _FlatObs, zr, active_flat):
    """Per-component weights (wu, wv, wr) and the scalar obs mask."""
    mask = f.base_ok & active_flat & (zr > 1e-3)
    mf = mask.astype(jnp.float32)
    wu = f.inv_s2 * mf
    wr = wu * f.stereo.astype(jnp.float32)
    return wu, wu, wr, mask


def _flat_chi2(pr, wu, wv, wr):
    return pr["ru"] ** 2 * wu + pr["rv"] ** 2 * wv + pr["rr"] ** 2 * wr


def _flat_cost(
    cam, T_all, p_w, f: _FlatObs, active_flat, use_huber, stereo_delta2,
    axis=None,
):
    """Total robustified cost (residual-only pass: no Jacobians).

    ``axis``: mesh axis name when the point dimension is sharded
    (shard_map) — the scalar cost is psum-reduced so every device sees
    the same LM accept/reject decision."""
    pr = _flat_project(cam, T_all, p_w, f)
    wu, wv, wr, mask = _flat_weights(f, pr["zr"], active_flat)
    chi2 = _flat_chi2(pr, wu, wv, wr)
    cost = jnp.where(use_huber, huber_cost(chi2, stereo_delta2), chi2)
    total = jnp.sum(cost * mask.astype(jnp.float32))
    if axis is not None:
        total = jax.lax.psum(total, axis)
    return total


class _FlatSystem(NamedTuple):
    """Normal-equation pieces of one state, carried across LM
    iterations so a REJECTED step re-solves from the cached system
    instead of recomputing Jacobians (g2o's factorization-retry loop).
    The robustified ``cost`` of the state rides along, so the LM loop
    needs exactly ONE observation pass per iteration — the candidate's
    system pass doubles as its accept/reject cost evaluation."""

    red: jax.Array  # (C,42) camera blocks [Hcc 36 | bc 6], psum'd
    Hpp: jax.Array  # (P,3,3)
    bp: jax.Array  # (P,3)
    Bq: jax.Array  # (18,Q) coupling columns B[i][k] at row i*3+k
    cost: jax.Array  # () robustified total, psum'd


def _flat_system(
    cam, T_all, p_w, prob: BAProblem, f: _FlatObs, active_flat,
    use_huber, axis=None,
) -> _FlatSystem:
    """One observation pass at (T_all, p_w): camera/point normal
    equations + coupling columns + robustified cost.

    With ``axis`` set (inside shard_map, points sharded over the mesh)
    the camera-system reductions — the incidence matmul and the cost —
    are psum-combined across devices; the per-point work stays
    device-local.
    """
    C, P, O = prob.C, prob.P, prob.obs_cam.shape[1]
    pr = _flat_project(cam, T_all, p_w, f)
    wu, wv, wr, mask = _flat_weights(f, pr["zr"], active_flat)
    delta2 = jnp.where(f.stereo, CHI2_STEREO, CHI2_MONO)
    chi2 = _flat_chi2(pr, wu, wv, wr)
    cost = jnp.sum(
        jnp.where(use_huber, huber_cost(chi2, delta2), chi2)
        * mask.astype(jnp.float32)
    )
    if axis is not None:
        cost = jax.lax.psum(cost, axis)
    hub = jnp.where(use_huber, huber_scale(chi2, delta2), 1.0)
    wu, wv, wr = wu * hub, wv * hub, wr * hub
    x, y, z, iz = pr["x"], pr["y"], pr["z"], pr["iz"]
    ru, rv, rr = pr["ru"], pr["rv"], pr["rr"]
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = pr["R"]
    iz2 = iz * iz
    a = cam.fx * iz          # du/dx
    c3 = -cam.fx * x * iz2   # du/dz
    d = cam.fy * iz          # dv/dy
    e = -cam.fy * y * iz2    # dv/dz
    cr = c3 + cam.bf * iz2   # dur/dz

    # J_pose rows (3 x 6), J = -d pred / d xi, xi = [rho, phi], left-mult.
    zero = jnp.zeros_like(a)
    Ju = (-a, zero, -c3, -c3 * y, -(a * z - c3 * x), a * y)
    Jv = (zero, -d, -e, -(-d * z + e * y), e * x, -d * x)
    Jr = (-a, zero, -cr, -cr * y, -(a * z - cr * x), a * y)
    # J_point rows (3 x 3): -(duvr/dpc) @ R.
    Pu = tuple(-(a * R0j + c3 * R2j) for R0j, R2j in ((R00, R20), (R01, R21), (R02, R22)))
    Pv = tuple(-(d * R1j + e * R2j) for R1j, R2j in ((R10, R20), (R11, R21), (R12, R22)))
    Pr_ = tuple(-(a * R0j + cr * R2j) for R0j, R2j in ((R00, R20), (R01, R21), (R02, R22)))

    def rowsum(Ai, Bj):
        """sum_c w_c * A_c[i] * B_c[j] for the 3 residual rows."""
        return wu * Ai[0] * Bj[0] + wv * Ai[1] * Bj[1] + wr * Ai[2] * Bj[2]

    Jp_cols = tuple(zip(Pu, Pv, Pr_))  # Jp_cols[j] = (Pu[j], Pv[j], Pr[j])
    Jc_cols = tuple(zip(Ju, Jv, Jr))

    # ---- point blocks: Hpp (P,3,3), bp (P,3) via (P,O) reductions ----
    def osum(q):
        # o-major: the per-point reduction is a lane-dense sublane sum.
        return jnp.sum(q.reshape(O, P), axis=0)

    Hpp = jnp.stack(
        [
            jnp.stack([osum(rowsum(Jp_cols[i], Jp_cols[j])) for j in range(3)], -1)
            for i in range(3)
        ],
        -2,
    )  # (P,3,3)
    rrow = (ru, rv, rr)
    bp = jnp.stack(
        [osum(rowsum(Jp_cols[i], rrow)) for i in range(3)], -1
    )  # (P,3)

    # ---- camera blocks via ONE incidence matmul ----------------------
    # columns: Hcc upper-triangle-full 36 + bc 6 = 42.  Stacked along
    # axis 0 — a (42, Q) layout with Q contiguous, rather than a (Q, 42)
    # stack with a 42-wide minor dimension on every elementwise consumer.
    cam_cols = [rowsum(Jc_cols[i], Jc_cols[j]) for i in range(6) for j in range(6)]
    cam_cols += [rowsum(Jc_cols[i], rrow) for i in range(6)]
    camMt = jnp.stack(cam_cols, 0)  # (42, Q)
    red = (camMt @ f.E).T  # (C, 42)
    if axis is not None:
        red = jax.lax.psum(red, axis)

    # ---- coupling columns B[i][k] = rowsum(Jc_i, Jp_k) ---------------
    Bq = jnp.stack(
        [rowsum(Jc_cols[i], Jp_cols[k]) for i in range(6) for k in range(3)],
        0,
    )  # (18, Q)
    return _FlatSystem(red=red, Hpp=Hpp, bp=bp, Bq=Bq, cost=cost)


def _flat_step(
    cam, prob: BAProblem, f: _FlatObs, sys: _FlatSystem, T_all, p_w, lam,
    axis=None,
):
    """Solve one damped step from a cached normal-equation system.

    Pure linear algebra — no observation pass; the Schur off-diagonal
    and reduced rhs are psum-combined when ``axis`` is set (points
    sharded; communication O(42*C + 36*C^2) floats per step,
    independent of the number of points, SURVEY.md §2c P6)."""
    C, P, O = prob.C, prob.P, prob.obs_cam.shape[1]

    def osum(q):
        return jnp.sum(q.reshape(O, P), axis=0)

    Hcc = sys.red[:, :36].reshape(C, 6, 6)
    bc = sys.red[:, 36:42]
    bp = sys.bp
    Hpp_d = sys.Hpp + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(sys.Hpp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    )
    Hpp_inv = inv3x3(Hpp_d)
    Hpp_inv = jnp.where(~prob.pt_valid[:, None, None], 0.0, Hpp_inv)

    Bc = [[sys.Bq[i * 3 + k] for k in range(3)] for i in range(6)]
    # Row-gather Hpp_inv as flat 9-wide rows (one efficient row gather;
    # a (Q,3,3) gather with its 3x3 minor dims is not lane-friendly).
    Hgf = Hpp_inv.reshape(P, 9)[f.p_idx]  # (Q,9)
    Hg = [[Hgf[:, 3 * j + k] for k in range(3)] for j in range(3)]
    BH = [
        [
            Bc[i][0] * Hg[0][k] + Bc[i][1] * Hg[1][k] + Bc[i][2] * Hg[2][k]
            for k in range(3)
        ]
        for i in range(6)
    ]
    B_stack = jnp.stack(
        [jnp.stack(Bc[i], -1) for i in range(6)], -2
    ).reshape(O, P, 6, 3)
    BH_stack = jnp.stack(
        [jnp.stack(BH[i], -1) for i in range(6)], -2
    ).reshape(O, P, 6, 3)
    # Schur coupling at HIGH (3-pass) matmul precision: the E operand is
    # one-hot (exact in bf16) and the accept/reject LM loop tolerates a
    # ~1e-6-relative Schur off-diagonal; the 6-pass package default was
    # measured as ~1/3 of the whole BA iteration.
    HIGH = jax.lax.Precision.HIGH
    E_po = f.E.reshape(O, P, C)
    U = jnp.einsum("opc,opik->pcik", E_po, BH_stack, precision=HIGH)
    V = jnp.einsum("opc,opjk->pcjk", E_po, B_stack, precision=HIGH)
    Um = U.transpose(1, 2, 0, 3).reshape(C * 6, P * 3)
    Vm = V.transpose(1, 2, 0, 3).reshape(C * 6, P * 3)
    S_off = jax.lax.dot(Um, Vm.T, precision=HIGH).reshape(
        C, 6, C, 6
    ).transpose(0, 2, 1, 3)
    corr_cam = jnp.einsum("pcik,pk->ci", U, bp, precision=HIGH)
    if axis is not None:
        S_off = jax.lax.psum(S_off, axis)
        corr_cam = jax.lax.psum(corr_cam, axis)
    bs = bc - corr_cam

    Hcc_d = Hcc + lam * jnp.eye(6) * jnp.maximum(
        jnp.trace(Hcc, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
    )
    S = -S_off
    S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc_d)
    free = prob.cam_valid & ~prob.cam_fixed
    fmask = free.astype(jnp.float32)
    S = S * fmask[:, None, None, None] * fmask[None, :, None, None]
    S = S.at[jnp.arange(C), jnp.arange(C)].add(
        jnp.where(free, 0.0, 1.0)[:, None, None] * jnp.eye(6)
    )
    bs = bs * fmask[:, None]

    dxc = -_cholesky_solve_blocks(S, bs)
    dxc = jnp.where(jnp.isfinite(dxc), dxc, 0.0)
    dxc_norm = jnp.linalg.norm(dxc, axis=-1, keepdims=True)
    dxc = jnp.where(dxc_norm < 1e3, dxc, 0.0)

    # back-substitute points: dxp = -Hpp^-1 (bp + sum_o B^T dxc[cam])
    dg = dxc[f.cam_idx]  # (Q,6) row gather
    corr = jnp.stack(
        [
            osum(sum(Bc[i][k] * dg[:, i] for i in range(6)))
            for k in range(3)
        ],
        -1,
    )  # (P,3)
    dxp = -jnp.einsum("pij,pj->pi", Hpp_inv, bp + corr)
    dxp = jnp.where(jnp.isfinite(dxp), dxp, 0.0)
    dxp_norm = jnp.linalg.norm(dxp, axis=-1, keepdims=True)
    dxp = jnp.where(dxp_norm < 1e3, dxp, 0.0)

    T_new = jax.vmap(lambda dd, TT: se3_exp(dd) @ TT)(dxc, T_all)
    T_new = jnp.where(free[:, None, None], T_new, T_all)
    p_new = jnp.where(prob.pt_valid[:, None], p_w + dxp, p_w)
    return T_new, p_new


def lm_solve(
    cam: CameraIntrinsics,
    prob: BAProblem,
    iters: int,
    use_huber: bool,
    active: jax.Array,
    lam0: float = 1e-4,
    axis=None,
    lam_init=None,
):
    """Fixed-iteration LM with accept/reject damping (flat fast path).

    ``axis`` shards the point dimension over a mesh axis (call inside
    shard_map with point-sharded ``prob`` leaves).  ``lam_init`` lets a
    chunked caller carry the damping state across chunks."""

    use_huber = jnp.asarray(use_huber)
    f = _flatten_obs(prob)
    active_flat = _po_flat(active)

    def system(T, p):
        return _flat_system(
            cam, T, p, prob, f, active_flat, use_huber, axis=axis
        )

    lam0_arr = jnp.float32(lam0) if lam_init is None else lam_init
    # ONE observation pass per iteration: the candidate state's system
    # pass carries its robustified cost, which IS the accept/reject
    # test; a rejected step re-solves from the cached system with a
    # larger lambda (g2o's factorization-retry).  Unrolled instead of
    # lax.scan: the body is a handful of small-C matmuls, so a device
    # loop's per-step overhead would dominate (as in optim/pose.py).
    sysc = system(prob.T_cw, prob.p_w)
    T, p, lam, cost = prob.T_cw, prob.p_w, lam0_arr, sysc.cost
    for _ in range(iters):
        T_new, p_new = _flat_step(cam, prob, f, sysc, T, p, lam, axis=axis)
        sys_new = system(T_new, p_new)
        accept = sys_new.cost < cost
        T = jnp.where(accept, T_new, T)
        p = jnp.where(accept, p_new, p)
        sysc = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), sys_new, sysc
        )
        lam = jnp.where(
            accept, jnp.maximum(lam * 0.5, 1e-8), jnp.minimum(lam * 5.0, 1e6)
        )
        cost = jnp.where(accept, sys_new.cost, cost)
    return T, p, cost, lam


@functools.partial(jax.jit, static_argnames=("iters1", "iters2"))
def bundle_adjust(
    cam: CameraIntrinsics,
    prob: BAProblem,
    iters1: int = 5,
    iters2: int = 10,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """The reference local-BA protocol (src/optimizer.cpp:287-314):
    ``iters1`` robust iterations, demote chi2-outlier observations, then
    ``iters2`` non-robust iterations, final outlier classification.

    Returns (T_cw (C,4,4), p_w (P,3), obs_outlier (P,O) bool).
    Use iters1=0, iters2=n for the plain global BA (optimizer.cpp:7-137
    runs a single phase with Huber kept).
    """
    active0 = prob.obs_valid
    delta2 = jnp.where(prob.obs_stereo, CHI2_STEREO, CHI2_MONO)
    f = _flatten_obs(prob)
    af0 = _po_flat(active0)

    def flat_chi2_mask(T, p, active_flat):
        """(P,O) raw chi2 + mask via the flat residual pass."""
        pr = _flat_project(cam, T, p, f)
        wu, wv, wr, mask = _flat_weights(f, pr["zr"], active_flat)
        chi2 = _flat_chi2(pr, wu, wv, wr)
        PP, OO = prob.P, prob.obs_cam.shape[1]
        return _po_unflat(chi2, PP, OO), _po_unflat(mask, PP, OO)

    if iters1 > 0:
        # Two-phase local-BA protocol: robust, demote, non-robust.
        T, p, _, _ = lm_solve(cam, prob, iters1, True, active0)
        chi2, mask = flat_chi2_mask(T, p, af0)
        inlier = mask & (chi2 <= delta2)
        T, p, _, _ = lm_solve(
            cam, prob._replace(T_cw=T, p_w=p), iters2, False, inlier
        )
    else:
        # Single robust phase: the reference global BA keeps Huber and
        # never demotes (optimizer.cpp:7-137).
        T, p, _, _ = lm_solve(cam, prob, iters2, True, active0)
    chi2, mask = flat_chi2_mask(T, p, af0)
    outlier = mask & (chi2 > delta2)
    return T, p, outlier


@functools.partial(jax.jit, static_argnames=("chunk",))
def _lm_chunk(cam, prob: BAProblem, T, p, lam, chunk: int = 5):
    """``chunk`` robust LM iterations carrying damping state."""
    T_new, p_new, _, lam_new = lm_solve(
        cam, prob._replace(T_cw=T, p_w=p), chunk, True, prob.obs_valid,
        lam_init=lam,
    )
    return T_new, p_new, lam_new


@jax.jit
def _classify_outliers(cam, prob: BAProblem, T, p):
    f = _flatten_obs(prob)
    pr = _flat_project(cam, T, p, f)
    wu, wv, wr, mask = _flat_weights(f, pr["zr"], _po_flat(prob.obs_valid))
    chi2 = _flat_chi2(pr, wu, wv, wr)
    P_, O = prob.obs_cam.shape
    delta2 = jnp.where(prob.obs_stereo, CHI2_STEREO, CHI2_MONO)
    return _po_unflat(mask, P_, O) & (_po_unflat(chi2, P_, O) > delta2)


def chunked_global_ba(
    cam: CameraIntrinsics,
    prob: BAProblem,
    iters: int,
    chunk: int = 5,
    should_abort=None,
):
    """Single-device global BA dispatched in bounded LM chunks.

    Same protocol as ``bundle_adjust(iters1=0)`` (single robust phase,
    optimizer.cpp:7-137) but the host regains control every ``chunk``
    iterations and consults ``should_abort()`` — the reference's
    interruptible global-BA force-stop (optimizer.cpp:17-19) without a
    thread.  Returns (T, p, obs_outlier).
    """
    T, p = prob.T_cw, prob.p_w
    lam = jnp.float32(1e-4)
    done = 0
    while done < iters:
        T, p, lam = _lm_chunk(cam, prob, T, p, lam, chunk=chunk)
        done += chunk
        if should_abort is not None and done < iters and should_abort():
            break
    return T, p, _classify_outliers(cam, prob, T, p)
