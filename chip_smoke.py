"""Smoke test of the SLAM main path on an NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA GPU:

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # sharded BA, retrieval and loop
                                       # correction on a 4-card mesh

One card runs these phases, each of which must pass:

  card tests  the ``gpu``-marked tests (tests/test_gpu_kernels.py): the
              best2 Triton kernel against the XLA reference at tracking
              and mapping widths, FAST+NMS against NumPy, the BA
              observation pass against the host CPU backend;
  kernels     best2 kernel and XLA reference timed in turns;
  rgbd        SlamSystem, RGB-D, pipelined, default CapacityConfig, 120
              synthetic 640x480 frames (uint8 gray, uint16 depth);
  stereo      SlamSystem, stereo, pipelined, 60 rectified 640x480 pairs;
  loop        the synchronous drifted-revisit recipe of
              tests/test_loop_organic.py: a loop closes and corrects.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed.  Without a GPU the script exits
non-zero and prints no such line.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
DEPTH_FACTOR = 5000.0  # TUM uint16 depth encoding (bench.py)

# Pass bounds: frames lost and ATE (m) of the same phase rehearsed on the
# CPU backend (CHANGES.md, PR 1).  A phase passes with no more lost
# frames than the rehearsal and ATE <= 1.5 x rehearsal + 5 mm.
REHEARSAL = {
    "rgbd": {"lost": 0, "ate": 0.006090578712869592},
    "stereo": {"lost": 0, "ate": 0.009163582941904754},
}


def log(*a):
    print(*a, flush=True)


def card_info() -> str:
    """Name and power limit from nvidia-smi (a child that stays off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def _bound(name, lost, ate):
    r = REHEARSAL[name]
    ok = lost <= r["lost"] and ate <= 1.5 * r["ate"] + 0.005
    log(f"{name}: pass bound lost <= {r['lost']}, "
        f"ATE <= {1.5 * r['ate'] + 0.005:.4f} m -> {'ok' if ok else 'FAIL'}")
    return ok


def _ate(system, gt_centers):
    """ATE RMSE (m) of the system's per-frame trajectory against exact
    ground-truth camera centres indexed by frame (timestamp * 30)."""
    import tempfile

    import numpy as np

    from ydorbslam_tpu.io import ate_rmse, read_tum_trajectory

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "traj.txt")
        system.save_trajectory_tum(path)
        ts, pos, _ = read_tum_trajectory(path)
    idx = np.rint(np.asarray(ts) * 30.0).astype(int)
    return ate_rmse(pos, gt_centers[idx])


class CompileCounter:
    """Counts XLA lowerings (one per new compiled program, persistent
    cache hit or not) while ``active``."""

    EVENT = "/jax/core/compile/jaxpr_to_mlir_module_duration"

    def __init__(self):
        import jax

        self.active = False
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw):
        if self.active and event == self.EVENT:
            self.count += 1


def rgbd_setup(n_frames):
    """The main phase's configuration, frames and ground-truth centres:
    bench.py's sequence, a bounded handheld oscillation over 1,500
    landmarks (the fr1/xyz workload shape), as uint8 gray and uint16
    depth."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synthetic import SyntheticRgbdSequence

    from ydorbslam_tpu.config import (CameraConfig, DepthConfig, OrbConfig,
                                      SlamConfig, TrackingConfig)

    seq = SyntheticRgbdSequence(np.random.default_rng(0), n_frames=n_frames,
                                n_landmarks=1500, trajectory="xyz")
    frames = []
    for i in range(n_frames):
        t, g, d = seq.frame(i)
        frames.append((t, g.astype(np.uint8),
                       (d * DEPTH_FACTOR).astype(np.uint16)))
    gt = np.stack([-p[:3, :3].T @ p[:3, 3] for p in seq.poses])
    cfg = SlamConfig(
        tracking=TrackingConfig(min_init_depth_points=100),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0,
                            width=640, height=480),
        orb=OrbConfig(n_features=1000),
        depth=DepthConfig(depth_map_factor=DEPTH_FACTOR),
    )
    return cfg, frames, gt


def rgbd_phase(counter=None, n_frames=120, n_warm=20, keep=None):
    """Main phase: RGB-D, pipelined, default capacity, host loop
    included.  Returns (ok, summary dict); appends the system to
    ``keep`` if given."""
    import jax
    import numpy as np

    from ydorbslam_tpu.slam.system import SlamSystem, Sensor

    cfg, frames, gt = rgbd_setup(n_frames)
    t0 = time.perf_counter()
    system = SlamSystem(cfg, Sensor.RGBD, enable_loop_closing=False)
    system.enable_pipelined(lag=16)
    system.precompile()
    for t, g, d in frames[:n_warm]:
        system.track_rgbd_pipelined(t, g, d)
    system.flush_pipeline()
    compile_s = time.perf_counter() - t0
    if counter is not None:
        counter.active = True
    times = []
    t_start = time.perf_counter()
    for t, g, d in frames[n_warm:]:
        t1 = time.perf_counter()
        system.track_rgbd_pipelined(t, g, d)
        times.append(time.perf_counter() - t1)
    system.shutdown()
    wall = time.perf_counter() - t_start
    if counter is not None:
        counter.active = False
    if keep is not None:
        keep.append(system)
    lost = sum(r.lost for r in system.records)
    ate = _ate(system, gt)
    ms = np.asarray(times) * 1000.0
    out = dict(
        frames=n_frames, warm_frames=n_warm, lost=lost, ate_m=ate,
        keyframes=system.n_keyframes, setup_s=compile_s,
        compiles_in_window=None if counter is None else counter.count,
        fps=(n_frames - n_warm) / wall,
        frame_ms_p50=float(np.percentile(ms, 50)),
        frame_ms_p95=float(np.percentile(ms, 95)),
        n_timed=len(times),
    )
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    ok = _bound("rgbd", lost, ate)
    if counter is not None and counter.count:
        log(f"rgbd: {counter.count} compiles inside the timed window")
        ok = False
    return ok, out


def stereo_phase(n_frames=60):
    """Stereo, pipelined: the row-band + SAD stereo front end on
    rectified 640x480 pairs.  Returns (ok, summary dict)."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_stereo_system import SyntheticStereoSequence

    from ydorbslam_tpu.config import (CameraConfig, OrbConfig, SlamConfig,
                                      TrackingConfig)
    from ydorbslam_tpu.slam.system import SlamSystem, Sensor

    seq = SyntheticStereoSequence(np.random.default_rng(0), n_frames=n_frames,
                                  n_landmarks=1500)
    cfg = SlamConfig(
        tracking=TrackingConfig(min_init_depth_points=100),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0,
                            width=640, height=480),
        orb=OrbConfig(n_features=1000),
    )
    t0 = time.perf_counter()
    system = SlamSystem(cfg, Sensor.STEREO, enable_loop_closing=False)
    system.enable_pipelined(lag=16)
    system.precompile()
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n_frames):
        t, left, right = seq.frame(i)
        # Sensor-native uint8, the encoding precompile() prepares for.
        system.track_stereo_pipelined(t, left.astype(np.uint8),
                                      right.astype(np.uint8))
    system.shutdown()
    wall = time.perf_counter() - t0
    gt = np.stack([-p[:3, :3].T @ p[:3, 3] for p in seq.inner.poses])
    lost = sum(r.lost for r in system.records)
    ate = _ate(system, gt)
    out = dict(frames=n_frames, lost=lost, ate_m=ate,
               keyframes=system.n_keyframes, setup_s=setup, run_s=wall)
    return _bound("stereo", lost, ate), out


def loop_phase():
    """tests/test_loop_organic.py's drifted revisit (seed 7), tracked
    synchronously: the loop must close and pull the pose back."""
    import dataclasses

    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synthetic import OrbitDriftSequence
    from test_slam_system import small_cfg

    from ydorbslam_tpu.config import LoopConfig
    from ydorbslam_tpu.slam.system import SlamSystem, Sensor

    seq = OrbitDriftSequence(np.random.default_rng(7), n_frames=40,
                             drift_rate=0.008)
    base = small_cfg()
    cfg = dataclasses.replace(
        base,
        loop=LoopConfig(min_kfs_between_loops=6,
                        covisibility_consistency_th=2, min_total_matches=30),
        capacity=dataclasses.replace(base.capacity, max_keyframes=64,
                                     max_map_points=8192),
    )
    t0 = time.perf_counter()
    system = SlamSystem(cfg, Sensor.RGBD, enable_loop_closing=True)
    n_total = seq.n_frames + 14
    errs, oks, loop_frame = [], [], None
    for i in range(n_total):
        t, g, d = seq.frame(i)
        oks.append(bool(system.track_rgbd(t + i * 1e-3, g, d)))
        T = np.asarray(system.tracker.T_cw)
        c_est = -T[:3, :3].T @ T[:3, 3]
        errs.append(float(np.linalg.norm(c_est - seq.gt_center_est_frame(i))))
        if loop_frame is None and system.loop_closer.n_loops_closed:
            loop_frame = i
    system.loop_closer.flush()
    stats = system.run_stats()
    out = dict(frames=n_total, tracked=sum(oks), loop_frame=loop_frame,
               loops_closed=stats["loops_closed"],
               global_ba_runs=stats["global_ba_runs"],
               run_s=time.perf_counter() - t0)
    if loop_frame is None or loop_frame >= n_total - 1:
        return False, out
    out["pre_err_m"] = max(errs[seq.n_frames - 8:loop_frame + 1])
    out["post_err_m"] = min(errs[loop_frame + 1:])
    ok = (sum(oks) > n_total * 0.8 and out["loops_closed"] >= 1
          and out["global_ba_runs"] >= 1
          and out["post_err_m"] < out["pre_err_m"] / 2)
    return ok, out


def card_tests_phase():
    """The gpu-marked tests, in this process (one process per card)."""
    import pytest

    class Tally:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1
            elif report.skipped:
                self.skipped += 1

    tally = Tally()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-o", "addopts=", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_gpu_kernels.py")],
        plugins=[tally],
    )
    out = dict(rc=int(rc), passed=tally.passed, failed=tally.failed,
               skipped=tally.skipped)
    return rc == 0 and tally.passed > 0 and not tally.skipped, out


def _time(fn, args, reps=20):
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e6


def kernel_timing_phase():
    """best2 Triton kernel and XLA reference at real widths, timed in
    turns (kernel, XLA, XLA, kernel); medians of 20 calls, microseconds,
    host clock around block_until_ready."""
    import functools

    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_gpu_kernels as g

    from ydorbslam_tpu.ops import best2 as b2

    cases = [
        ("window2 check_ur 8192x1024", "window2", True,
         g.track_problem(np.random.default_rng(1))),
        ("window 8192x1024", "window", False,
         g.track_problem(np.random.default_rng(2))),
        ("fuse 10x1024x1024", "fuse", False,
         g.pair_problem(np.random.default_rng(3), "fuse")),
        ("epi 10x1024x1024", "epi", False,
         g.pair_problem(np.random.default_rng(4), "epi")),
    ]
    out = {}
    for name, mode, cu, args in cases:
        args = jax.device_put(args)
        k = functools.partial(b2.best2_pallas, mode=mode, check_ur=cu)
        x = functools.partial(b2.best2_reference, mode=mode, check_ur=cu)
        tk1, tx1, tx2, tk2 = (_time(k, args), _time(x, args),
                              _time(x, args), _time(k, args))
        out[name] = dict(kernel_us=[tk1, tk2], xla_us=[tx1, tx2])
    return True, out


def _vectorised_index(rng, K, n_kp):
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_gpu_kernels as g

    from ydorbslam_tpu.slam.retrieval import add_keyframe, empty_index

    idx = empty_index(K)
    valid = jnp.ones(n_kp, bool)
    descs = g.rand_desc(rng, (K, n_kp))
    for k in range(K):
        idx = add_keyframe(idx, k, jnp.asarray(descs[k]), valid)
    return idx, descs


def four_card_phase(n_cards=4):
    """Sharded global BA, sharded retrieval and the loop correction on a
    1-D mesh of ``n_cards`` cards, each against its one-device path."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_gpu_kernels as g
    from test_ba import CAM

    import __graft_entry__
    from ydorbslam_tpu.config import CapacityConfig
    from ydorbslam_tpu.optim.schur import _lm_iteration
    from ydorbslam_tpu.parallel.ba_sharded import sharded_ba_step
    from ydorbslam_tpu.parallel.retrieval_sharded import sharded_topk_scores
    from ydorbslam_tpu.slam.retrieval import bow_histogram, score_all

    devs = jax.devices()
    if len(devs) != n_cards:
        raise RuntimeError(f"need {n_cards} cards, JAX sees {len(devs)}")
    mesh = Mesh(np.asarray(devs), axis_names=("obs",))
    cap = CapacityConfig()
    out, ok = {}, True

    # Global BA size: global_ba_max_points x global_ba_obs, 64 cameras.
    prob = g.ba_problem_np(np.random.default_rng(0), C=64,
                           P=cap.global_ba_max_points, O=cap.global_ba_obs)
    lam = 1e-4
    t0 = time.perf_counter()
    T_ref, p_ref = jax.jit(_lm_iteration)(
        CAM, prob.T_cw, prob.p_w, prob, prob.obs_valid, jnp.float32(lam),
        jnp.asarray(True),
    )
    T_sh, p_sh = sharded_ba_step(mesh, CAM, prob, lam=lam)
    T_ref, p_ref, T_sh, p_sh = (np.asarray(x) for x in
                                (T_ref, p_ref, T_sh, p_sh))
    dT = float(np.abs(T_sh - T_ref).max() / np.abs(T_ref).max())
    dp = float(np.abs(p_sh - p_ref).max() / np.abs(p_ref).max())
    ba_ok = bool(np.all(np.isfinite(T_sh)) and dT <= 1e-4 and dp <= 1e-4)
    out["sharded_ba"] = dict(points=cap.global_ba_max_points,
                             obs_per_point=cap.global_ba_obs, cameras=64,
                             rel_err_T=dT, rel_err_p=dp, ok=ba_ok,
                             s=time.perf_counter() - t0)
    ok &= ba_ok

    # Retrieval over max_keyframes keyframes.
    K = cap.max_keyframes
    rng = np.random.default_rng(1)
    idx, descs = _vectorised_index(rng, K, 1024)
    q = bow_histogram(jnp.asarray(descs[37]), jnp.ones(1024, bool))
    _, dense = score_all(idx, q)
    ids, scores = sharded_topk_scores(mesh, idx, q, k=8)
    dense = np.asarray(dense)
    want = np.argsort(-dense, kind="stable")[:8]
    ids, scores = np.asarray(ids), np.asarray(scores)
    r_ok = bool(set(ids.tolist()) == set(want.tolist()) and ids[0] == 37
                and np.array_equal(np.sort(scores), np.sort(dense[want])))
    out["sharded_retrieval"] = dict(keyframes=K, top=ids.tolist(), ok=r_ok)
    ok &= r_ok

    n_loops, sharded = __graft_entry__._dryrun_loop_correction()
    l_ok = n_loops >= 1 and sharded
    out["loop_correction"] = dict(loops=n_loops, used_sharded_detect=sharded,
                                  ok=l_ok)
    ok &= l_ok
    return ok, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1

    # The GPU and the host backend (the BA pass is compared with it); no
    # CPU fallback: JAX fails at start if CUDA does not come up.
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    if n_cards == 1:
        # With several cards visible the loop closer would shard without
        # being asked; keep this process on one card.
        if "CUDA_VISIBLE_DEVICES" not in os.environ:
            os.environ["CUDA_VISIBLE_DEVICES"] = "0"
            log("restricting JAX to card 0 (CUDA_VISIBLE_DEVICES=0)")
    log("card:", card_info())

    import jax
    import jaxlib

    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: no GPU: {e}", file=sys.stderr)
        return 2
    if devs[0].platform != "gpu":
        print(f"chip_smoke: default device is {devs[0].platform}, not a GPU",
              file=sys.stderr)
        return 2
    if len(devs) != n_cards:
        print(f"chip_smoke: need exactly {n_cards} card(s), JAX sees "
              f"{len(devs)}", file=sys.stderr)
        return 2
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__}; device "
        f"{devs[0].device_kind} x{len(devs)}; compile cache "
        f"{jax.config.jax_compilation_cache_dir}")

    import ydorbslam_tpu  # noqa: F401  (sets precision and cache)

    log(f"matmul precision {jax.config.jax_default_matmul_precision} "
        "(full float32; TF32 not in use)")
    if n_cards == 1:
        counter = CompileCounter()
        phases = [
            ("card tests", card_tests_phase),
            ("kernels", kernel_timing_phase),
            ("rgbd", lambda: rgbd_phase(counter)),
            ("stereo", stereo_phase),
            ("loop", loop_phase),
        ]
    else:
        phases = [("four cards", four_card_phase)]
    all_ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            ok, res = fn()
        except Exception:
            traceback.print_exc()
            ok, res = False, {"error": "exception (traceback on stderr)"}
        res["wall_s"] = time.perf_counter() - t0
        log(f"phase {name}: {'PASS' if ok else 'FAIL'} {json.dumps(res)}")
        all_ok &= ok
    card = card_info()
    log("card:", card)
    if not all_ok:
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
