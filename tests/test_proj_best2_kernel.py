"""Golden parity: the best2 Triton kernel (Pallas interpreter) vs the
XLA matcher path.

On the GPU the tracking matchers run the projection-gated Triton kernel
(ops/best2.best2_pallas); elsewhere they run the dense XLA reference.
Pallas's interpreter runs the kernel body on the CPU, so these tests pin
both to identical results on the same random problem, exercising every
gate the kernel evaluates (window, octave range, stereo right-x
coherence, validity, narrow/wide radii)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ydorbslam_tpu.ops.extractor import FrameFeatures
from ydorbslam_tpu.slam import matchers as mt


def _rand_feats(rng, n, width=640.0, height=480.0):
    uv = rng.uniform([8, 8], [width - 8, height - 8], (n, 2)).astype(np.float32)
    return FrameFeatures(
        uv=jnp.asarray(uv),
        uv_raw=jnp.asarray(uv),
        response=jnp.asarray(rng.uniform(1, 100, n).astype(np.float32)),
        octave=jnp.asarray(rng.integers(0, 8, n).astype(np.int32)),
        angle=jnp.asarray(rng.uniform(0, 2 * np.pi, n).astype(np.float32)),
        desc=jnp.asarray(rng.integers(0, 2**32, (n, 8), dtype=np.uint32)),
        right_u=jnp.asarray(
            np.where(rng.random(n) < 0.7,
                     uv[:, 0] - rng.uniform(1, 30, n), -1.0).astype(np.float32)
        ),
        depth=jnp.asarray(rng.uniform(0.5, 8, n).astype(np.float32)),
        valid=jnp.asarray(rng.random(n) < 0.9),
    )


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    M, N = 512, 256
    curr = _rand_feats(rng, N)
    # Sources roughly at current keypoint locations so windows gate
    # non-trivially: half near a current keypoint, half random.
    tgt = rng.integers(0, N, M)
    u = np.asarray(curr.uv)[tgt, 0] + rng.normal(0, 6, M)
    v = np.asarray(curr.uv)[tgt, 1] + rng.normal(0, 6, M)
    src_desc = np.asarray(curr.desc)[tgt].copy()
    flip = rng.integers(0, 2**32, (M, 8), dtype=np.uint32) & rng.integers(
        0, 2**32, (M, 8), dtype=np.uint32
    ) & rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    src_desc ^= flip  # a few flipped bits
    return dict(
        rng=rng, M=M, N=N, curr=curr,
        src_desc=jnp.asarray(src_desc),
        u=jnp.asarray(u.astype(np.float32)),
        v=jnp.asarray(v.astype(np.float32)),
        ur=jnp.asarray((u - rng.uniform(1, 30, M)).astype(np.float32)),
        rad_n=jnp.asarray(rng.uniform(4, 10, M).astype(np.float32)),
        oct_lo=jnp.asarray(rng.integers(-1, 3, M).astype(np.int32)),
        oct_hi=jnp.asarray(rng.integers(4, 9, M).astype(np.int32)),
        valid=jnp.asarray(rng.random(M) < 0.9),
    )


def _jnp_best2(src_desc, proj_valid, curr, pair_mask):
    from ydorbslam_tpu.ops.hamming import (
        INVALID_DIST, best_and_second, masked_distance_matrix,
    )
    d = masked_distance_matrix(src_desc, curr.desc, proj_valid, curr.valid, pair_mask)
    return best_and_second(d), d


@pytest.mark.parametrize("check_ur", [False, True])
def test_kernel_matches_xla_gates(problem, check_ur):
    from ydorbslam_tpu.ops.best2 import best2_pallas

    p = problem
    curr = p["curr"]
    rad_w = p["rad_n"] * 2.0
    attr_a = mt._pack_src_attr(
        p["u"], p["v"], p["ur"], p["rad_n"], rad_w,
        p["oct_lo"], p["oct_hi"], p["valid"],
    )
    out = best2_pallas(
        p["src_desc"][None], attr_a[None], curr.desc[None],
        mt._pack_cur_attr(curr)[None], "window2", check_ur=check_ur,
        interpret=True,
    )
    (i_n, b_n, s_n), (i_w, b_w, s_w) = [tuple(x[0] for x in o) for o in out]
    for rad, (idx, b1, b2) in [(p["rad_n"], (i_n, b_n, s_n)),
                               (rad_w, (i_w, b_w, s_w))]:
        du = jnp.abs(curr.uv[None, :, 0] - p["u"][:, None])
        dv = jnp.abs(curr.uv[None, :, 1] - p["v"][:, None])
        win = (du <= rad[:, None]) & (dv <= rad[:, None])
        if check_ur:
            has_r = curr.right_u[None, :] >= 0
            ur_ok = jnp.abs(curr.right_u[None, :] - p["ur"][:, None]) <= rad[:, None]
            win &= jnp.where(has_r, ur_ok, True)
        win &= (curr.octave[None, :] >= p["oct_lo"][:, None]) & (
            curr.octave[None, :] <= p["oct_hi"][:, None]
        )
        (ri, rb1, rb2), d = _jnp_best2(p["src_desc"], p["valid"], curr, win)
        from ydorbslam_tpu.ops.hamming import INVALID_DIST

        has = rb1 < INVALID_DIST
        np.testing.assert_array_equal(np.asarray(b1 < 10_000), np.asarray(has))
        np.testing.assert_array_equal(
            np.asarray(jnp.where(has, idx, -9)), np.asarray(jnp.where(has, ri, -9))
        )
        np.testing.assert_array_equal(
            np.asarray(jnp.where(has, b1, -9)), np.asarray(jnp.where(has, rb1, -9))
        )
        # second-best: kernel 10_000 sentinel == INVALID_DIST semantics
        k2 = np.asarray(jnp.where(has, jnp.minimum(b2, 256), -9))
        r2 = np.asarray(jnp.where(has, jnp.minimum(rb2, 256), -9))
        np.testing.assert_array_equal(k2, r2)


def test_full_matchers_pallas_vs_xla(problem, monkeypatch):
    """match_local_points / match_motion_model_two / match_dense produce
    identical assignments through the kernel and the XLA reference."""
    from ydorbslam_tpu.ops import best2 as b2

    def kernel_interpret(*args):
        return b2.best2_pallas(*args, interpret=True)

    p = problem
    rng = np.random.default_rng(11)
    curr = p["curr"]
    M, N = p["M"], p["N"]
    from ydorbslam_tpu.config import CameraConfig, SlamConfig
    from ydorbslam_tpu.slam.system import camera_intrinsics

    cam = camera_intrinsics(SlamConfig(camera=CameraConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0, width=640, height=480)))

    # world points ~2-8m in front of an identity camera
    z = rng.uniform(1.0, 8.0, M)
    u = np.asarray(p["u"], np.float64)
    v = np.asarray(p["v"], np.float64)
    pw = np.stack([(u - 320.0) * z / 500.0, (v - 240.0) * z / 500.0, z], -1)
    mp_pos = jnp.asarray(pw.astype(np.float32))
    mp_normal = jnp.asarray((-pw / np.linalg.norm(pw, axis=-1, keepdims=True)
                             ).astype(np.float32) * -1.0)
    dist = np.linalg.norm(pw, axis=-1)
    mp_maxd = jnp.asarray((dist * rng.uniform(1.0, 1.5, M)).astype(np.float32))
    mp_mind = jnp.asarray((dist * rng.uniform(0.3, 0.9, M)).astype(np.float32))
    T = jnp.eye(4)

    args_local = (cam, curr, T, mp_pos, p["src_desc"], mp_normal,
                  mp_maxd, mp_mind, p["valid"])
    kw = dict(th=1.0, n_levels=8, scale_factor=1.2)
    lm_valid = p["valid"] & (jnp.arange(M) % 7 != 0)
    T_pred = jnp.eye(4).at[0, 3].set(0.02)
    last = _rand_feats(np.random.default_rng(13), M)
    args_motion = (cam, curr, last, mp_pos, lm_valid, T_pred, T)
    mkw = dict(th_narrow=7.0, th_wide=14.0, n_levels=8, scale_factor=1.2)
    args_dense = (p["src_desc"], p["valid"],
                  jnp.asarray(rng.uniform(0, 2 * np.pi, M).astype(np.float32)),
                  curr.desc, curr.valid, curr.angle)

    results = {}
    for use in (False, True):
        monkeypatch.setattr(
            mt, "best2", kernel_interpret if use else b2.best2_reference
        )
        a1, d1 = mt.match_local_points(*args_local, **kw)
        m1, m2 = mt.match_motion_model_two(*args_motion, **mkw)
        a3, d3 = mt.match_dense(*args_dense, max_dist=50, ratio=0.7)
        results[use] = [np.asarray(x) for x in (a1, m1, m2, a3)]
        # jit caches would mix paths between the two sweeps
        mt.match_local_points._clear_cache()
        mt.match_motion_model_two._clear_cache()
        mt.match_dense._clear_cache()
    for a, b in zip(results[False], results[True]):
        np.testing.assert_array_equal(a, b)
