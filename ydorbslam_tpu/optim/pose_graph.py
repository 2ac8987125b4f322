"""Sim3 pose-graph optimization (the essential graph).

Replaces ``Optimizer::optimizeEssentialGraph`` (src/optimizer.cpp:
502-661, g2o BlockSolver_7_3 + VertexSim3Expmap/EdgeSim3, lambda_0 =
1e-16 i.e. effectively Gauss-Newton): vertices are per-keyframe Sim3
poses; edges are spanning-tree links, loop edges, and strong
covisibility pairs (weight >= 100); the residual of edge (i, j) with
measurement S_ji is

    e = log_sim3( S_ji_meas @ S_i @ S_j^-1 )    (7-vector)

Jacobians via jax.jacfwd on left-multiplied tangent perturbations —
exact, batched over all edges at once.  The normal equations assemble
with segment-sums into a dense (7V, 7V) system solved by Cholesky
(V <= a few hundred keyframes: small dense algebra).  Fixed vertices (the loop
keyframe, reference optimizer.cpp:545) get identity rows.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry.sim3 import inv_S, sim3_exp, sim3_log


class PoseGraphProblem(NamedTuple):
    S_iw: jax.Array  # (V,4,4) current Sim3 keyframe poses (world->kf)
    fixed: jax.Array  # (V,) bool
    vertex_valid: jax.Array  # (V,) bool
    edge_i: jax.Array  # (E,) i32
    edge_j: jax.Array  # (E,) i32
    edge_meas: jax.Array  # (E,4,4) measured S_ji = S_i_meas @ S_j_meas^-1 ... see note
    edge_valid: jax.Array  # (E,) bool
    edge_weight: jax.Array  # (E,) f32 information scale


def edge_measurement(S_i: jax.Array, S_j: jax.Array) -> jax.Array:
    """Measurement for edge (i,j): S_ij_meas = S_i @ S_j^-1, so that the
    residual log(S_meas @ S_j @ S_i^-1) is zero at the measured
    configuration."""
    return S_i @ inv_S(S_j)


def _edge_residual(S_meas, S_i, S_j, eps_i, eps_j, fix_scale):
    if fix_scale:
        eps_i = eps_i.at[6].set(0.0)
        eps_j = eps_j.at[6].set(0.0)
    Si = sim3_exp(eps_i) @ S_i
    Sj = sim3_exp(eps_j) @ S_j
    return sim3_log(S_meas @ Sj @ inv_S(Si))


@functools.partial(jax.jit, static_argnames=("iters", "fix_scale"))
def optimize_pose_graph(
    prob: PoseGraphProblem, iters: int = 20, fix_scale: bool = False
) -> jax.Array:
    """-> optimized (V,4,4) Sim3 poses.

    ``fix_scale`` pins sigma=0 for stereo/RGB-D essential graphs
    (the reference passes bFixScale=true for non-monocular,
    loopClosing.cpp:318 / optimizer.cpp vertex->_fix_scale).
    """
    V = prob.S_iw.shape[0]
    E = prob.edge_i.shape[0]
    ic = jnp.clip(prob.edge_i, 0, V - 1)
    jc = jnp.clip(prob.edge_j, 0, V - 1)

    def one_iteration(S_all, _):
        S_i = S_all[ic]
        S_j = S_all[jc]
        zeros = jnp.zeros((E, 7))

        def res(meas, si, sj, ei, ej):
            return _edge_residual(meas, si, sj, ei, ej, fix_scale)

        r = jax.vmap(res)(prob.edge_meas, S_i, S_j, zeros, zeros)  # (E,7)
        Ji = jax.vmap(jax.jacfwd(res, argnums=3))(
            prob.edge_meas, S_i, S_j, zeros, zeros
        )  # (E,7,7)
        Jj = jax.vmap(jax.jacfwd(res, argnums=4))(
            prob.edge_meas, S_i, S_j, zeros, zeros
        )
        w = (prob.edge_valid.astype(jnp.float32) * prob.edge_weight)[:, None, None]
        # Assemble H (V,V,7,7) and b (V,7) with segment sums.
        Hii = jax.ops.segment_sum(
            w * jnp.einsum("eci,ecj->eij", Ji, Ji), ic, num_segments=V
        )
        Hjj = jax.ops.segment_sum(
            w * jnp.einsum("eci,ecj->eij", Jj, Jj), jc, num_segments=V
        )
        Hij_blocks = w * jnp.einsum("eci,ecj->eij", Ji, Jj)
        seg_ij = ic * V + jc
        seg_ji = jc * V + ic
        H_off = jax.ops.segment_sum(
            Hij_blocks, seg_ij, num_segments=V * V
        ) + jax.ops.segment_sum(
            jnp.swapaxes(Hij_blocks, -1, -2), seg_ji, num_segments=V * V
        )
        b = jax.ops.segment_sum(
            (w[:, :, 0] * jnp.einsum("eci,ec->ei", Ji, r)), ic, num_segments=V
        ) + jax.ops.segment_sum(
            (w[:, :, 0] * jnp.einsum("eci,ec->ei", Jj, r)), jc, num_segments=V
        )
        H = H_off.reshape(V, V, 7, 7)
        H = H.at[jnp.arange(V), jnp.arange(V)].add(Hii + Hjj)
        free = prob.vertex_valid & ~prob.fixed
        fm = free.astype(jnp.float32)
        H = H * fm[:, None, None, None] * fm[None, :, None, None]
        H = H.at[jnp.arange(V), jnp.arange(V)].add(
            jnp.where(free, 1e-6, 1.0)[:, None, None] * jnp.eye(7)
        )
        b = b * fm[:, None]
        Hd = H.transpose(0, 2, 1, 3).reshape(V * 7, V * 7)
        dx = -jnp.linalg.solve(Hd, b.reshape(-1)).reshape(V, 7)
        if fix_scale:
            dx = dx.at[:, 6].set(0.0)
        S_new = jax.vmap(lambda d, S: sim3_exp(d) @ S)(dx, S_all)
        S_new = jnp.where(free[:, None, None], S_new, S_all)
        return S_new, None

    S_out, _ = jax.lax.scan(one_iteration, prob.S_iw, None, length=iters)
    return S_out
