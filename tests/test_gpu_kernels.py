"""Card-only checks at the widths the system runs: the best2 Triton
kernel against the XLA reference, FAST+NMS against NumPy, and the BA
observation pass against the host CPU backend.

Every test here needs an NVIDIA GPU (``gpu`` marker and fixture) and
skips elsewhere; ``chip_smoke.py`` runs them on the card.  The problem
generators and checkers are shared with ``chip_smoke.py`` and with the
CPU tests of the same paths (tests/test_xla_paths.py).
"""
import numpy as np
import pytest

TRACK_M = 8192  # CapacityConfig.tracking_points
KP_N = 1024  # CapacityConfig.max_keypoints
PAIRS = 10  # covisible neighbours per keyframe (N_TRIANG_NEIGHBORS)
INVALID = 10_000  # ops.hamming.INVALID_DIST


def rand_desc(rng, shape):
    return rng.integers(0, 2**32, shape + (8,), dtype=np.uint64).astype(
        np.uint32
    )


def _quarter(x):
    """Quarter-pixel grid: every gate difference and product is exact in
    float32, so a fused multiply-add on the card cannot move a gate."""
    return (np.round(np.asarray(x) * 4) / 4).astype(np.float32)


def track_problem(rng, M=TRACK_M, N=KP_N):
    """One tracking search: M projected map points against the N
    keypoints of the current frame, rows clustered near keypoints so the
    windows gate non-trivially.  Returns (desc_a, attr_a, desc_b, attr_b)
    with a leading pair axis of 1 (ops.best2 A_*/B_* lanes)."""
    desc_b = rand_desc(rng, (N,))
    bu = _quarter(rng.uniform(8, 632, N))
    bv = _quarter(rng.uniform(8, 472, N))
    bur = np.where(rng.random(N) < 0.7, _quarter(bu - rng.uniform(1, 30, N)),
                   -1.0).astype(np.float32)
    boct = rng.integers(0, 8, N).astype(np.float32)
    tgt = rng.integers(0, N, M)
    flip = (rand_desc(rng, (M,)) & rand_desc(rng, (M,)) & rand_desc(rng, (M,)))
    desc_a = desc_b[tgt] ^ flip
    au = _quarter(bu[tgt] + rng.normal(0, 6, M))
    av = _quarter(bv[tgt] + rng.normal(0, 6, M))
    aur = _quarter(au - rng.uniform(1, 30, M))
    rn = _quarter(rng.uniform(4, 10, M))
    olo = rng.integers(-1, 3, M).astype(np.float32)
    ohi = rng.integers(4, 9, M).astype(np.float32)
    attr_a = np.stack([au, av, aur, rn, 2 * rn, olo, ohi,
                       (rng.random(M) < 0.9).astype(np.float32)], -1)
    z = np.zeros(N, np.float32)
    attr_b = np.stack([bu, bv, bur, boct,
                       (rng.random(N) < 0.9).astype(np.float32), z, z, z], -1)
    return desc_a[None], attr_a[None], desc_b[None], attr_b[None]


def pair_problem(rng, mode, B=PAIRS, N=KP_N):
    """B keyframe pairs of N keypoints for the "fuse" or "epi" search."""
    desc_b = rand_desc(rng, (B, N))
    tgt = rng.integers(0, N, (B, N))
    flip = rand_desc(rng, (B, N)) & rand_desc(rng, (B, N))
    desc_a = np.take_along_axis(desc_b, tgt[..., None], 1) ^ flip
    bu = _quarter(rng.uniform(0, 640, (B, N)))
    bv = _quarter(rng.uniform(0, 480, (B, N)))
    boct = rng.integers(0, 4, (B, N)).astype(np.float32)
    bval = (rng.random((B, N)) > 0.1).astype(np.float32)
    z = np.zeros((B, N), np.float32)
    if mode == "fuse":
        au = _quarter(np.take_along_axis(bu, tgt, 1) + rng.normal(0, 2, (B, N)))
        av = _quarter(np.take_along_axis(bv, tgt, 1) + rng.normal(0, 2, (B, N)))
        aur = _quarter(au - rng.uniform(1, 30, (B, N)))
        bur = np.where(rng.random((B, N)) < 0.6,
                       _quarter(bu - rng.uniform(1, 30, (B, N))), -1.0)
        rad = _quarter(rng.uniform(3, 15, (B, N)))
        olo = rng.integers(-1, 3, (B, N)).astype(np.float32)
        attr_a = np.stack([au, av, aur, rad, rad, olo, olo + 1,
                           (rng.random((B, N)) > 0.1).astype(np.float32)], -1)
        isf2 = (1.0 / 2.0 ** boct / 64.0).astype(np.float32)
        attr_b = np.stack([bu, bv, bur.astype(np.float32), boct, bval, isf2,
                           z, z], -1)
    else:  # "epi": small-integer lines keep num = a*u + b*v + c exact
        la = rng.integers(-3, 4, (B, N)).astype(np.float32)
        lb = rng.integers(-3, 4, (B, N)).astype(np.float32)
        lc = rng.integers(-1500, 1500, (B, N)).astype(np.float32)
        thr = 3.84 * (la * la + lb * lb)
        attr_a = np.stack([la, lb, lc, thr,
                           rng.integers(0, 4, (B, N)).astype(np.float32),
                           (rng.random((B, N)) > 0.1).astype(np.float32),
                           z, z], -1)
        sig2 = (256.0 * 2.0 ** boct).astype(np.float32)
        attr_b = np.stack([bu, bv, sig2, boct, bval, z, z, z], -1)
    return desc_a, attr_a.astype(np.float32), desc_b, attr_b


def hamming_rows(desc_a, desc_b, idx):
    """Hamming distance of each row to its chosen column (numpy)."""
    cols = np.take_along_axis(desc_b, np.clip(idx, 0, None)[..., None], -2)
    x = np.bitwise_xor(desc_a, cols)
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def check_best2(desc_a, desc_b, got, want):
    """Best and second distances equal as integers; indices equal where
    the best is unique; on a tie the chosen index carries the best
    distance.  Returns the number of rows with a candidate."""
    hits = 0
    for (gi, g1, g2), (wi, w1, w2) in zip(got, want):
        gi, g1, g2 = (np.asarray(x) for x in (gi, g1, g2))
        wi, w1, w2 = (np.asarray(x) for x in (wi, w1, w2))
        np.testing.assert_array_equal(g1, w1)
        np.testing.assert_array_equal(g2, w2)
        has = w1 < INVALID
        np.testing.assert_array_equal(gi >= 0, has)
        unique = has & (w1 < w2)
        np.testing.assert_array_equal(gi[unique], wi[unique])
        d = hamming_rows(desc_a, desc_b, gi)
        np.testing.assert_array_equal(d[has], g1[has])
        hits += int(has.sum())
    return hits


FAST_OFFSETS = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]


def fast_nms_numpy(img, border=16):
    """FAST-9 corner score (largest threshold at which the segment test
    passes) with 3x3 non-max suppression and the border mask, written
    directly from the definition: for each of the 16 arc starts, the
    minimum signed difference over 9 contiguous circle pixels."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    pad = np.pad(img, 3, mode="edge")
    circle = [pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
              for dx, dy in FAST_OFFSETS]
    score = np.zeros_like(img)
    for sign in (1.0, -1.0):
        for k in range(16):
            arc = sign * circle[k]
            for j in range(1, 9):
                arc = np.minimum(arc, sign * circle[(k + j) % 16])
            score = np.maximum(score, arc)
    nb = np.pad(score, 1, constant_values=-1.0)
    peak = np.ones_like(score, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                peak &= score >= nb[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    rows, cols = np.arange(h)[:, None], np.arange(w)[None, :]
    inside = ((rows >= border) & (rows < h - border)
              & (cols >= border) & (cols < w - border))
    return np.where(peak & inside, score, 0.0).astype(np.float32)


def textured_frame(rng, h=480, w=640):
    """uint8 frame with blobs and edges (many FAST corners)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = 60 + 40 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    for _ in range(400):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(2, 6)
        img[max(cy - r, 0):cy + r, max(cx - r, 0):cx + r] = rng.integers(0, 256)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def ba_problem_np(rng, C, P, O, noise=0.5, perturb=0.02):
    """Vectorised synthetic BA problem (cameras on an arc, points in
    front, O observations per point) as an optim.schur.BAProblem."""
    import jax.numpy as jnp

    from ydorbslam_tpu.geometry import se3_exp
    from ydorbslam_tpu.optim.schur import BAProblem

    if O > C:
        raise ValueError(f"{O} observations per point need >= {O} cameras")
    xi = np.zeros((C, 6), np.float32)
    ang = np.linspace(0.0, 0.6, C)
    xi[:, 0] = 0.5 * np.sin(ang)
    xi[:, 2] = 0.2 * ang
    xi[:, 4] = ang
    T_true = np.stack([np.asarray(se3_exp(jnp.asarray(x))) for x in xi])
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                    rng.uniform(4, 10, P)], -1).astype(np.float32)
    cams = np.argsort(rng.random((P, C)), axis=1)[:, :O].astype(np.int32)
    T = T_true[cams]  # (P,O,4,4)
    pc = np.einsum("poij,pj->poi", T[..., :3, :3], pts) + T[..., :3, 3]
    z = np.maximum(pc[..., 2], 1e-3)
    u = 500.0 * pc[..., 0] / z + 320.0
    v = 500.0 * pc[..., 1] / z + 240.0
    uvr = np.stack([u, v, u - 50.0 / z], -1)
    uvr = (uvr + rng.normal(0, noise, uvr.shape)).astype(np.float32)
    T_init = T_true.copy()
    for i in range(1, C):
        T_init[i] = np.asarray(
            se3_exp(jnp.asarray(rng.normal(0, perturb, 6).astype(np.float32)))
        ) @ T_true[i]
    pts_init = pts + rng.normal(0, 5 * perturb, pts.shape).astype(np.float32)
    return BAProblem(
        T_cw=jnp.asarray(T_init),
        cam_fixed=jnp.zeros(C, bool).at[0].set(True),
        cam_valid=jnp.ones(C, bool),
        p_w=jnp.asarray(pts_init),
        pt_valid=jnp.ones(P, bool),
        obs_cam=jnp.asarray(cams),
        obs_uvr=jnp.asarray(uvr),
        obs_inv_sigma2=jnp.asarray(
            (1.0 / 1.44 ** rng.integers(0, 4, (P, O))).astype(np.float32)),
        obs_stereo=jnp.asarray(rng.random((P, O)) < 0.7),
        obs_valid=jnp.asarray(rng.random((P, O)) < 0.95),
    )


def flat_system_on(device, prob, use_huber=True):
    """optim.schur._flat_system of ``prob`` computed on ``device``."""
    import jax
    import jax.numpy as jnp

    from test_ba import CAM
    from ydorbslam_tpu.optim import schur

    prob = jax.device_put(prob, device)
    with jax.default_device(device):
        f = schur._flatten_obs(prob)
        out = jax.jit(schur._flat_system)(
            CAM, prob.T_cw, prob.p_w, prob, f,
            schur._po_flat(prob.obs_valid), jnp.asarray(use_huber),
        )
    return jax.device_get(out)


# ----------------------------------------------------------------------
# Card-only tests
# ----------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("check_ur", [False, True])
def test_best2_kernel_tracking_width(gpu, check_ur):
    from ydorbslam_tpu.ops import best2 as b2

    args = track_problem(np.random.default_rng(1 + check_ur))
    got = b2.best2_pallas(*args, "window2", check_ur)
    want = b2.best2_reference(*args, "window2", check_ur)
    assert check_best2(args[0], args[2], got, want) > TRACK_M // 4


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fuse", "epi"])
def test_best2_kernel_mapping_width(gpu, mode):
    from ydorbslam_tpu.ops import best2 as b2

    args = pair_problem(np.random.default_rng(3), mode)
    got = b2.best2_pallas(*args, mode)
    want = b2.best2_reference(*args, mode)
    assert check_best2(args[0], args[2], got, want) > PAIRS * KP_N // 20


@pytest.mark.gpu
def test_fast_nms_gpu_matches_numpy(gpu):
    import jax.numpy as jnp

    from ydorbslam_tpu.ops.fast import fast_score_map, nms_and_border

    img = textured_frame(np.random.default_rng(4))
    got = nms_and_border(fast_score_map(jnp.asarray(img, jnp.float32)), 16)
    want = fast_nms_numpy(img)
    assert (want > 0).sum() > 1000
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.gpu
def test_flat_system_gpu_matches_cpu(gpu):
    """Local-BA size: local_ba_max_points x local_ba_obs observations.
    At "highest" precision (set by the package) no dot runs in TF32, so
    the card agrees with the host to float32 rounding of the sums."""
    import jax

    from ydorbslam_tpu.config import CapacityConfig

    cap = CapacityConfig()
    assert jax.config.jax_default_matmul_precision == "highest"
    prob = ba_problem_np(np.random.default_rng(5), C=cap.local_ba_window_kf,
                         P=cap.local_ba_max_points, O=cap.local_ba_obs)
    got = flat_system_on(gpu, prob)
    want = flat_system_on(jax.devices("cpu")[0], prob)
    for name in got._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
