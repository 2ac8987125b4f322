"""Observation-sharded optimization steps over a device mesh.

The reference has NO distributed backend — its concurrency is 4-5 POSIX
threads over a mutex-guarded shared map (SURVEY.md §2c).  This module is
the multi-device replacement: observations (the dominant axis of BA
work) are sharded over a ``jax.sharding.Mesh`` axis, each device
accumulates its block of the normal equations, and the reduced system is
``psum``-combined (NCCL over NVLink between the cards of a host) and
solved replicated.  The same pattern
scales the Schur-complement local/global BA (optim/schur.py) to
multi-host meshes: camera blocks replicate, landmark blocks stay
device-local, only the (small) reduced camera system crosses the
interconnect.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry.camera import CameraIntrinsics
from ..geometry.se3 import se3_exp
from ..optim.residuals import batched_residual_and_jacobians, observation_weights
from ..optim.schur import (
    BAProblem, CHI2_MONO, CHI2_STEREO, _per_obs, _weights, inv3x3,
)
from ..optim.residuals import chi2_per_obs, huber_scale


def sharded_pose_step(
    mesh: Mesh,
    cam: CameraIntrinsics,
    T_cw: jax.Array,
    p_w: jax.Array,
    obs_uvr: jax.Array,
    inv_sigma2: jax.Array,
    valid: jax.Array,
) -> jax.Array:
    """One Gauss-Newton pose step with observations sharded over 'obs'.

    Each device computes J/r for its observation shard and the 6x6
    H = sum J^T W J, b = sum J^T W r partial sums; psum over the mesh
    axis reduces them; the solve is replicated (6x6 — cheaper to
    recompute everywhere than to broadcast).
    """
    axis = mesh.axis_names[0]

    def step(T, p, o, s2, v):
        r, J, _, depth = batched_residual_and_jacobians(cam, T, p, o)
        w = observation_weights(o[:, 2] > -1e8, s2)  # all rows stereo-capable
        m = (v & (depth > 1e-3)).astype(jnp.float32)[:, None]
        H = jax.lax.psum(jnp.einsum("nci,nc,ncj->ij", J, w * m, J), axis)
        b = jax.lax.psum(jnp.einsum("nci,nc,nc->i", J, w * m, r), axis)
        dx = -jnp.linalg.solve(H + 1e-6 * jnp.eye(6), b)
        return se3_exp(dx) @ T

    shard = P(axis)
    repl = P()
    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(repl, shard, shard, shard, shard),
        out_specs=repl,
    )
    return jax.jit(fn)(T_cw, p_w, obs_uvr, inv_sigma2, valid)


def sharded_ba_step(
    mesh: Mesh,
    cam: CameraIntrinsics,
    prob: BAProblem,
    lam: float = 1e-4,
):
    """One Schur-complement BA Gauss-Newton step with the POINT axis of
    the problem sharded over the mesh — the map-block partition of
    SURVEY.md §2c P6.

    Per device (its point block stays local):
      * residuals/Jacobians for local observations,
      * exact 3x3 landmark marginalization (Hpp^-1, local),
      * partial camera-diagonal blocks, Schur off-diagonal blocks and
        reduced rhs — each psum-reduced across the mesh,
      * the (6C, 6C) reduced camera system solved replicated,
      * landmark back-substitution entirely local (no communication).

    Communication volume per step: O(C^2 * 36) floats for S plus
    O(C * 6) for the rhs — independent of the number of points, which is
    what makes the map-block partition scale.

    Returns (T_new (C,4,4) replicated, p_new (P,3) sharded-consistent).
    """
    axis = mesh.axis_names[0]
    C = prob.C
    O = prob.obs_cam.shape[1]

    def step(T_all, p_w, obs_cam, obs_uvr, obs_is2, obs_st, obs_ok, pt_ok,
             cam_fixed, cam_valid):
        Pl = p_w.shape[0]  # local point count
        local = BAProblem(
            T_cw=T_all, cam_fixed=cam_fixed, cam_valid=cam_valid,
            p_w=p_w, pt_valid=pt_ok, obs_cam=obs_cam, obs_uvr=obs_uvr,
            obs_inv_sigma2=obs_is2, obs_stereo=obs_st, obs_valid=obs_ok,
        )
        r, Jc, Jp, z = _per_obs(cam, T_all, p_w, local)
        w3, mask = _weights(local, z, obs_ok)
        delta2 = jnp.where(obs_st, CHI2_STEREO, CHI2_MONO)
        chi2 = chi2_per_obs(r, w3)
        w = w3 * huber_scale(chi2, delta2)[..., None]

        Hpp = jnp.einsum("poci,poc,pocj->pij", Jp, w, Jp)
        bp = jnp.einsum("poci,poc,poc->pi", Jp, w, r)
        Hpp_d = Hpp + lam * jnp.eye(3) * jnp.maximum(
            jnp.trace(Hpp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
        )
        Hpp_inv = jnp.where(pt_ok[:, None, None], inv3x3(Hpp_d), 0.0)

        camc = jnp.clip(obs_cam, 0, C - 1).reshape(-1)
        Hcc = jax.lax.psum(
            jax.ops.segment_sum(
                jnp.einsum("poci,poc,pocj->poij", Jc, w, Jc).reshape(-1, 6, 6),
                camc, num_segments=C,
            ),
            axis,
        )
        bc = jax.lax.psum(
            jax.ops.segment_sum(
                jnp.einsum("poci,poc,poc->poi", Jc, w, r).reshape(-1, 6),
                camc, num_segments=C,
            ),
            axis,
        )
        B = jnp.einsum("poci,poc,pocj->poij", Jc, w, Jp)
        BHinv = jnp.einsum("poij,pjk->poik", B, Hpp_inv)
        pair = jnp.einsum("poik,pqjk->poqij", BHinv, B)
        ci = jnp.broadcast_to(camc.reshape(Pl, O)[:, :, None], (Pl, O, O))
        cj = jnp.broadcast_to(camc.reshape(Pl, O)[:, None, :], (Pl, O, O))
        S_off = jax.lax.psum(
            jax.ops.segment_sum(
                pair.reshape(-1, 6, 6), (ci * C + cj).reshape(-1),
                num_segments=C * C,
            ),
            axis,
        ).reshape(C, C, 6, 6)
        bs = bc - jax.lax.psum(
            jax.ops.segment_sum(
                jnp.einsum("poik,pk->poi", BHinv, bp).reshape(-1, 6),
                camc, num_segments=C,
            ),
            axis,
        )

        Hcc_d = Hcc + lam * jnp.eye(6) * jnp.maximum(
            jnp.trace(Hcc, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
        )
        S = -S_off
        S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc_d)
        free = cam_valid & ~cam_fixed
        fm = free.astype(jnp.float32)
        S = S * fm[:, None, None, None] * fm[None, :, None, None]
        S = S.at[jnp.arange(C), jnp.arange(C)].add(
            jnp.where(free, 0.0, 1.0)[:, None, None] * jnp.eye(6)
        )
        bs = bs * fm[:, None]
        from ..optim.schur import _pcg_solve_blocks

        dxc = -_pcg_solve_blocks(S, bs)
        # Local landmark back-substitution.
        dxc_obs = dxc[camc.reshape(Pl, O)]
        corr = jnp.einsum("poij,poi->pj", B, dxc_obs)
        dxp = -jnp.einsum("pij,pj->pi", Hpp_inv, bp + corr)
        T_new = jax.vmap(lambda d, T: se3_exp(d) @ T)(dxc, T_all)
        T_new = jnp.where(free[:, None, None], T_new, T_all)
        p_new = jnp.where(pt_ok[:, None], p_w + dxp, p_w)
        return T_new, p_new

    sp = P(axis)
    rp = P()
    fn = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(rp, sp, sp, sp, sp, sp, sp, sp, rp, rp),
        out_specs=(rp, sp),
    )
    return jax.jit(fn)(
        prob.T_cw, prob.p_w, prob.obs_cam, prob.obs_uvr,
        prob.obs_inv_sigma2, prob.obs_stereo, prob.obs_valid, prob.pt_valid,
        prob.cam_fixed, prob.cam_valid,
    )


# ---------------------------------------------------------------------
# Production sharded global BA: the full LM protocol (not just one GN
# step) with the POINT axis sharded over the mesh, dispatched in
# host-visible chunks so loop correction can be interrupted between
# chunks (the reference's force-stop flag, optimizer.cpp:17-19 /
# SURVEY.md §2c P3, re-expressed as bounded iteration chunks).
# ---------------------------------------------------------------------

import functools as _functools

from ..optim.schur import (
    _flat_chi2, _flat_project, _flat_weights, _flatten_obs, _po_flat,
    _po_unflat, lm_solve,
)


@_functools.lru_cache(maxsize=8)
def _sharded_lm_chunk(mesh: Mesh, chunk: int, use_huber: bool):
    """Jitted point-sharded LM chunk: (prob leaves, lam) -> (T, p, lam).

    Cached per (mesh, chunk, robustness) so repeated chunk dispatches hit
    the same executable.
    """
    axis = mesh.axis_names[0]

    def body(cam, T, cam_fixed, cam_valid, p_w, pt_valid, obs_cam, obs_uvr,
             obs_is2, obs_st, obs_ok, lam):
        local = BAProblem(
            T_cw=T, cam_fixed=cam_fixed, cam_valid=cam_valid,
            p_w=p_w, pt_valid=pt_valid, obs_cam=obs_cam, obs_uvr=obs_uvr,
            obs_inv_sigma2=obs_is2, obs_stereo=obs_st, obs_valid=obs_ok,
        )
        T_new, p_new, _, lam_new = lm_solve(
            cam, local, chunk, use_huber, obs_ok, axis=axis, lam_init=lam,
        )
        return T_new, p_new, lam_new

    sp, rp = P(axis), P()
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(rp, rp, rp, rp, sp, sp, sp, sp, sp, sp, sp, rp),
        out_specs=(rp, sp, rp),
    )
    return jax.jit(fn)


@_functools.lru_cache(maxsize=8)
def _sharded_classify(mesh: Mesh):
    """Jitted point-sharded chi2 outlier classification."""
    axis = mesh.axis_names[0]

    def body(cam, T, cam_fixed, cam_valid, p_w, pt_valid, obs_cam, obs_uvr,
             obs_is2, obs_st, obs_ok):
        local = BAProblem(
            T_cw=T, cam_fixed=cam_fixed, cam_valid=cam_valid,
            p_w=p_w, pt_valid=pt_valid, obs_cam=obs_cam, obs_uvr=obs_uvr,
            obs_inv_sigma2=obs_is2, obs_stereo=obs_st, obs_valid=obs_ok,
        )
        f = _flatten_obs(local)
        pr = _flat_project(cam, T, p_w, f)
        wu, wv, wr, mask = _flat_weights(f, pr["zr"], _po_flat(obs_ok))
        chi2 = _flat_chi2(pr, wu, wv, wr)
        Pl, O = obs_cam.shape
        delta2 = jnp.where(obs_st, CHI2_STEREO, CHI2_MONO)
        return _po_unflat(mask, Pl, O) & (_po_unflat(chi2, Pl, O) > delta2)

    sp, rp = P(axis), P()
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(rp, rp, rp, rp, sp, sp, sp, sp, sp, sp, sp),
        out_specs=sp,
    )
    return jax.jit(fn)


def sharded_bundle_adjust(
    mesh: Mesh,
    cam: CameraIntrinsics,
    prob: BAProblem,
    iters: int,
    chunk: int = 5,
    should_abort=None,
):
    """Map-block-partitioned global BA over a device mesh.

    Runs the reference's single-phase robust global BA
    (optimizer.cpp:7-137: Huber kept, 10 iterations after a loop,
    loopClosing.cpp:380) with points sharded over ``mesh``; LM damping
    carries across chunks, and ``should_abort()`` is consulted between
    chunks — the bounded-chunk equivalent of g2o's force-stop flag
    (optimizer.cpp:17-19).

    prob.P must be divisible by the mesh size (capacities are powers of
    two).  Returns (T_new, p_new, obs_outlier) like bundle_adjust.
    """
    n = int(np.prod([d for d in mesh.devices.shape]))
    assert prob.P % n == 0, (prob.P, n)
    step = _sharded_lm_chunk(mesh, chunk, True)
    classify = _sharded_classify(mesh)
    leaves = (
        prob.cam_fixed, prob.cam_valid, prob.p_w, prob.pt_valid,
        prob.obs_cam, prob.obs_uvr, prob.obs_inv_sigma2, prob.obs_stereo,
        prob.obs_valid,
    )
    T, p = prob.T_cw, prob.p_w
    lam = jnp.float32(1e-4)
    done = 0
    while done < iters:
        T, p, lam = step(
            cam, T, leaves[0], leaves[1], p, leaves[3], leaves[4],
            leaves[5], leaves[6], leaves[7], leaves[8], lam,
        )
        done += chunk
        if should_abort is not None and done < iters and should_abort():
            break
    outlier = classify(
        cam, T, leaves[0], leaves[1], p, leaves[3], leaves[4],
        leaves[5], leaves[6], leaves[7], leaves[8],
    )
    return T, p, outlier
