"""SE(3) tangent-space operations, batched and jit-friendly.

Replaces the reference's g2o ``SE3Quat`` / Eigen machinery
(reference: src/converter.hpp:24-35, thirdParty/g2o/g2o/types/sba) with
pure-functional JAX ops.  All functions are shape-polymorphic over
leading batch dimensions via explicit broadcasting (use ``jax.vmap`` for
batching), and run in float32 by default — accelerators have no fast
float64, so numerical conditioning (world-centering, damping) is handled by the
optimizers instead of extended precision.

Conventions:
  * A pose is a 4x4 homogeneous matrix ``T`` with ``T = [[R, t], [0, 1]]``.
  * Camera poses are world-to-camera (``T_cw``), matching the reference's
    ``m_cvMat_T_c2w`` (src/frame.hpp).
  * A twist is a length-6 vector ``xi = [rho, phi]`` with translational
    part ``rho`` first and rotational part ``phi`` second;
    ``exp(xi) = [[exp([phi]x), V(phi) rho], [0, 1]]``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(phi: jax.Array) -> jax.Array:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(M: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def so3_exp(phi: jax.Array) -> jax.Array:
    """Rodrigues' formula with small-angle Taylor guards. (...,3)->(...,3,3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks near 0.
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = hat(phi)
    K2 = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R: jax.Array) -> jax.Array:
    """Log map of SO(3): (...,3,3) -> (...,3). Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - jnp.swapaxes(R, -1, -2))  # = 2 sin(theta) * axis
    # Recover theta from atan2(|w|, trace): |w| gives sin(theta) directly,
    # which avoids the 1/sin(theta) error amplification of
    # arccos(trace) near theta = pi (critical in float32).  The epsilon
    # inside the sqrt keeps the derivative finite at the identity, where
    # d|w|/dw would otherwise be NaN — this function is differentiated
    # by the pose-graph optimizer at exactly-satisfied edges.
    sin_t = 0.5 * jnp.sqrt(jnp.sum(w * w, axis=-1) + _EPS * _EPS)
    theta = jnp.arctan2(sin_t, cos_t)
    # theta/(2 sin theta) with Taylor near 0.
    near_zero = theta < 1e-4
    scale = jnp.where(
        near_zero,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * jnp.maximum(sin_t, _EPS)),
    )
    phi = scale[..., None] * w
    # Near pi the vee-based formula degenerates (w -> 0); recover the axis
    # from the exact identity (R + R^T)/2 = cos(t) I + (1-cos(t)) a a^T.
    near_pi = theta > 3.1386  # within ~3e-3 of pi
    sym = 0.5 * (R + jnp.swapaxes(R, -1, -2))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    outer = (sym - cos_t[..., None, None] * eye) / jnp.maximum(
        1.0 - cos_t[..., None, None], 0.5
    )
    diag = jnp.stack([outer[..., 0, 0], outer[..., 1, 1], outer[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(
        outer, k[..., None, None].repeat(3, axis=-2), axis=-1
    )[..., 0]
    axis = col / jnp.maximum(jnp.linalg.norm(col, axis=-1, keepdims=True), _EPS)
    # Fix the sign so that axis matches w where w is nonzero.
    sign = jnp.where(jnp.sum(axis * w, axis=-1, keepdims=True) < 0.0, -1.0, 1.0)
    phi_pi = theta[..., None] * axis * sign
    return jnp.where(near_pi[..., None], phi_pi, phi)


def _left_jacobian(phi: jax.Array) -> jax.Array:
    """SO(3) left Jacobian V(phi) such that exp-se3 t-part = V rho."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    K = hat(phi)
    K2 = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * K2


def _left_jacobian_inv(phi: jax.Array) -> jax.Array:
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = theta * 0.5
    cot = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS)) / theta2,
    )
    K = hat(phi)
    K2 = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye - 0.5 * K + cot[..., None, None] * K2


def se3_exp(xi: jax.Array) -> jax.Array:
    """exp: (...,6) twist [rho, phi] -> (...,4,4) homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return make_T(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """log: (...,4,4) -> (...,6) twist [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    rho = (_left_jacobian_inv(phi) @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def make_T(R: jax.Array, t: jax.Array) -> jax.Array:
    """Assemble (...,4,4) from (...,3,3) rotation and (...,3) translation."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def inv_T(T: jax.Array) -> jax.Array:
    """Inverse of a rigid transform without a general 4x4 solve."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def orthonormalize_T(T: jax.Array) -> jax.Array:
    """Project the rotation block back onto SO(3) (Gram-Schmidt).

    The tracking state's pose feeds a multiplicative feedback loop
    (velocity = T_new inv(T_last); prediction = velocity T_last): the
    two factors carry CORRELATED f32 error, so the orthogonality defect
    roughly DOUBLES every frame — measured growing 1e-7 -> 0.29 in 18
    frames.  One projection per pose solve keeps the chain on the
    manifold, which both preserves accuracy and makes the closed-form
    rigid inverse (``inv_T``) exact.
    """
    R = T[..., :3, :3]
    c0 = R[..., :, 0]
    c0 = c0 / jnp.maximum(jnp.linalg.norm(c0, axis=-1, keepdims=True), 1e-12)
    c1 = R[..., :, 1]
    c1 = c1 - jnp.sum(c0 * c1, axis=-1, keepdims=True) * c0
    c1 = c1 / jnp.maximum(jnp.linalg.norm(c1, axis=-1, keepdims=True), 1e-12)
    c2 = jnp.cross(c0, c1)
    Rn = jnp.stack([c0, c1, c2], axis=-1)
    return make_T(Rn, T[..., :3, 3])


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (...,4,4) to (...,N,3) points -> (...,N,3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def rot_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix -> quaternion (x, y, z, w), TUM export order.

    Branchless Shepperd's method: compute all four candidate encodings and
    select the numerically largest, so it is safe for any rotation.
    Matches the output contract of the reference trajectory writer
    (src/system.cpp:193-261 uses Eigen quaternions in x y z w order).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidates for (w, x, y, z), scaled; pick by largest pivot.
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)
    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    k = jnp.argmax(pivots, axis=-1)
    cand = jnp.stack([qw, qx, qy, qz], axis=-2)  # (...,4 cand,4 comps) in (w,x,y,z)
    q = jnp.take_along_axis(cand, k[..., None, None].repeat(4, axis=-1), axis=-2)[
        ..., 0, :
    ]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    # Canonical sign: w >= 0.
    q = q * jnp.where(q[..., :1] < 0.0, -1.0, 1.0)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([x, y, z, w], axis=-1)


def quat_to_rot(q_xyzw: jax.Array) -> jax.Array:
    """Quaternion (x, y, z, w) -> rotation matrix (...,3,3)."""
    q = q_xyzw / jnp.maximum(jnp.linalg.norm(q_xyzw, axis=-1, keepdims=True), _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
