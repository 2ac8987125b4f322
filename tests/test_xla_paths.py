"""CPU checks of the plain-XLA paths the GPU runs without a custom
kernel, and of the package's backend choices: FAST+NMS against NumPy,
the BA observation pass against autodiff normal equations, the RGB-D
depth gather, the compile-cache placement, the kernel dispatch, and
chip_smoke.py's refusal to run without a GPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_ba import CAM, make_ba_problem
from test_gpu_kernels import fast_nms_numpy, textured_frame, track_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(137, 201), (96, 128)])
def test_fast_nms_matches_numpy(shape):
    from ydorbslam_tpu.ops.fast import fast_score_map, nms_and_border

    img = textured_frame(np.random.default_rng(shape[0]), *shape)
    got = nms_and_border(fast_score_map(jnp.asarray(img, jnp.float32)), 16)
    want = fast_nms_numpy(img, 16)
    assert (want > 0).sum() > 20
    np.testing.assert_array_equal(np.asarray(got), want)


def _autodiff_system(prob, use_huber):
    """Normal equations of the robustified reprojection cost built from
    jax.jacfwd of optim/residuals.project_point under left-multiplied
    pose increments — independent of schur's hand-derived Jacobians."""
    from ydorbslam_tpu.geometry import se3_exp
    from ydorbslam_tpu.optim.residuals import (
        huber_cost, huber_scale, project_point,
    )

    C, (P, O) = prob.T_cw.shape[0], prob.obs_cam.shape
    cams = jnp.clip(prob.obs_cam, 0, C - 1)

    def res(xi, X, T, obs):
        return obs - project_point(CAM, se3_exp(xi) @ T, X)[1]

    def one(c, X, obs):
        T = prob.T_cw[c]
        z0 = jnp.zeros(6)
        r = res(z0, X, T, obs)
        Jc = jax.jacfwd(res, 0)(z0, X, T, obs)  # (3,6)
        Jp = jax.jacfwd(res, 1)(z0, X, T, obs)  # (3,3)
        zr = (T[:3, :3] @ X + T[:3, 3])[2]
        return r, Jc, Jp, zr

    r, Jc, Jp, zr = jax.vmap(jax.vmap(one, (0, None, 0)), (0, 0, 0))(
        cams, prob.p_w, prob.obs_uvr
    )
    mask = (prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
            & (zr > 1e-3)).astype(jnp.float32)
    st = prob.obs_stereo.astype(jnp.float32)
    w = prob.obs_inv_sigma2[..., None] * mask[..., None] * jnp.stack(
        [jnp.ones_like(st), jnp.ones_like(st), st], -1)
    chi2 = jnp.sum(r * r * w, -1)
    delta2 = jnp.where(prob.obs_stereo, 7.815, 5.991)
    cost = jnp.sum(jnp.where(use_huber, huber_cost(chi2, delta2), chi2) * mask)
    w = w * jnp.where(use_huber, huber_scale(chi2, delta2), 1.0)[..., None]
    Hcc = jnp.einsum("poki,pok,pokj->poij", Jc, w, Jc)
    bc = jnp.einsum("poki,pok,pok->poi", Jc, w, r)
    red = jax.ops.segment_sum(
        jnp.concatenate([Hcc.reshape(P, O, 36), bc], -1).reshape(P * O, 42),
        cams.reshape(-1), num_segments=C,
    )
    Hpp = jnp.einsum("poki,pok,pokj->pij", Jp, w, Jp)
    bp = jnp.einsum("poki,pok,pok->pi", Jp, w, r)
    Bq = jnp.einsum("poki,pok,pokj->ijop", Jc, w, Jp).reshape(18, O * P)
    return dict(red=red, Hpp=Hpp, bp=bp, Bq=Bq, cost=cost)


@pytest.mark.parametrize("use_huber", [True, False])
def test_flat_system_matches_autodiff(rng, use_huber):
    from ydorbslam_tpu.optim import schur

    prob, _, _, _ = make_ba_problem(rng, C=6, P=100, O=6, noise=0.5,
                                    perturb=0.05, outlier_frac=0.1)
    f = schur._flatten_obs(prob)
    got = schur._flat_system(
        CAM, prob.T_cw, prob.p_w, prob, f, schur._po_flat(prob.obs_valid),
        jnp.asarray(use_huber),
    )
    want = _autodiff_system(prob, jnp.asarray(use_huber))
    # Two float32 derivations of the same Jacobians (closed form vs
    # forward-mode through se3_exp): agreement to float32 rounding of
    # sums whose terms reach ~1e6.
    for name, w in want.items():
        g, w = np.asarray(getattr(got, name)), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_fill_depth_gather_matches_numpy(rng):
    from ydorbslam_tpu.ops.extractor import empty_features
    from ydorbslam_tpu.ops.stereo import fill_depth_from_rgbd

    n, h, w = 64, 48, 80
    depth = rng.uniform(0.5, 5.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.2] = 0.0  # holes
    uv = np.stack([rng.uniform(-2, w + 2, n), rng.uniform(-2, h + 2, n)],
                  -1).astype(np.float32)
    valid = rng.random(n) < 0.9
    feats = empty_features(n)._replace(
        uv=jnp.asarray(uv + 0.25), uv_raw=jnp.asarray(uv),
        valid=jnp.asarray(valid),
    )
    out = fill_depth_from_rgbd(feats, jnp.asarray(depth), CAM)
    ui = np.clip(np.round(uv[:, 0]).astype(int), 0, w - 1)
    vi = np.clip(np.round(uv[:, 1]).astype(int), 0, h - 1)
    d = depth[vi, ui]
    ok = valid & (d > 0)
    np.testing.assert_array_equal(np.asarray(out.depth),
                                  np.where(ok, d, -1.0).astype(np.float32))
    right = np.where(ok, uv[:, 0] + 0.25 - CAM.bf / np.maximum(d, 1e-6), -1.0)
    np.testing.assert_allclose(np.asarray(out.right_u), right, rtol=1e-6)


def _cache_dir(env_update):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_update, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import ydorbslam_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("preset", [True, False])
def test_compile_cache_placement(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR wins untouched; without it the cache is
    the fixed in-checkout .jax_cache/ (listed in .gitignore)."""
    if preset:
        want = str(tmp_path / "jcache")
        assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": want}) == want
    else:
        want = os.path.join(REPO, ".jax_cache")
        assert _cache_dir({}) == want
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_best2_dispatch_off_gpu():
    """Off the GPU the one dispatch function takes the XLA reference."""
    from ydorbslam_tpu.ops import best2 as b2

    assert jax.default_backend() != "gpu"
    assert not b2.use_kernel()
    args = track_problem(np.random.default_rng(0), M=96, N=64)
    got = b2.best2(*args, "window2", True)
    want = b2.best2_reference(*args, "window2", True)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
