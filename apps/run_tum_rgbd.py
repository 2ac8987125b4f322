#!/usr/bin/env python
"""TUM RGB-D sequence runner — the reference driver contract.

Mirrors test/src/test.cpp: parse an association file, construct the
system, feed frames, print MEDIAN and MEAN tracking time
(test.cpp:98-106), write CameraTrajectory.txt / KeyFrameTrajectory.txt
(test.cpp:109-110).  Optionally evaluates ATE RMSE against a
groundtruth.txt (the reference leaves this to external TUM tools).

Usage:
  python apps/run_tum_rgbd.py CONFIG.yaml SEQUENCE_DIR ASSOC.txt \
      [--groundtruth GT.txt] [--no-loop] [--max-frames N] [--viz out.png]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("sequence_dir")
    ap.add_argument("assoc")
    ap.add_argument("--groundtruth", default=None)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--no-mapping", action="store_true")
    ap.add_argument("--pipelined", action="store_true",
                    help="use the dispatch-ahead device pipeline (the "
                         "fast path) instead of per-frame sync")
    ap.add_argument("--lag", type=int, default=16)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--out-trajectory", default="CameraTrajectory.txt")
    ap.add_argument("--out-kf-trajectory", default="KeyFrameTrajectory.txt")
    ap.add_argument("--viz", default=None, help="write a map/trajectory PNG")
    ap.add_argument("--viewer-dir", default=None,
                    help="periodic in-run rendering (frame+map PNGs)")
    ap.add_argument("--viewer-every", type=int, default=30)
    args = ap.parse_args()

    # Join a multi-host runtime when configured (env-gated no-op
    # single-process) BEFORE any other jax call creates a backend.
    from ydorbslam_tpu.parallel.multihost import (initialize_distributed,
                                                  process_info)

    if initialize_distributed():
        print(f"distributed: {process_info()}")

    from ydorbslam_tpu.config import load_config
    from ydorbslam_tpu.io import TumRgbdDataset, ate_rmse, read_tum_trajectory
    from ydorbslam_tpu.io.trajectory import associate_by_time
    from ydorbslam_tpu.slam.system import SlamSystem, Sensor

    cfg = load_config(args.config)
    ds = TumRgbdDataset(
        args.sequence_dir, args.assoc, cfg.depth.depth_map_factor,
        is_rgb=cfg.camera.is_rgb,
    )
    n = len(ds) if not args.max_frames else min(args.max_frames, len(ds))
    print(f"sequence: {n} frames; starting SLAM")

    system = SlamSystem(
        cfg, Sensor.RGBD,
        enable_mapping=not args.no_mapping,
        enable_loop_closing=not args.no_loop,
    )
    if args.pipelined:
        system.enable_pipelined(lag=args.lag)
        system.precompile()
    if args.viewer_dir:
        system.attach_viewer(args.viewer_dir, every=args.viewer_every)
    track = (
        system.track_rgbd_pipelined if args.pipelined else system.track_rgbd
    )
    times = []
    for i in range(n):
        t, gray, depth = ds[i]
        t0 = time.perf_counter()
        track(t, gray, depth)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(
                f"frame {i}/{n} state={system.tracking_state().name} "
                f"inliers={system.tracked_map_points()} kfs={system.n_keyframes}"
            )
    system.shutdown()

    # median/mean tracking time report (test.cpp:98-106 contract)
    stimes = sorted(times[3:]) or times
    print(f"median tracking time: {stimes[len(stimes) // 2]:.4f}")
    print(f"mean tracking time: {sum(stimes) / len(stimes):.4f}")

    system.save_trajectory_tum(args.out_trajectory)
    system.save_keyframe_trajectory_tum(args.out_kf_trajectory)
    print(f"trajectories saved: {args.out_trajectory}, {args.out_kf_trajectory}")

    from ydorbslam_tpu.slam.stats import format_stats

    print("--- run stats ---")
    print(format_stats(system.run_stats()))

    if system.frame_trace is not None:
        print("--- frame trace (i mode ok inl [need] [INS]) ---")
        for i, (_ts, mode, ok, inl, need, ins) in enumerate(system.frame_trace):
            flags = ("" if not need else " need") + ("" if not ins else " INS")
            print(f"{i:4d} m{mode} {'ok' if ok else 'LOST':4s} {inl:4d}{flags}")

    if args.viz:
        from ydorbslam_tpu.viz.headless import render_map_topdown

        render_map_topdown(system.map, args.viz)
        print(f"map rendering saved: {args.viz}")

    if args.groundtruth:
        gt = np.loadtxt(args.groundtruth, comments="#", ndmin=2)
        t_est, p_est, _ = read_tum_trajectory(args.out_trajectory)
        ia, ib = associate_by_time(t_est, gt[:, 0])
        if len(ia) >= 3:
            err = ate_rmse(p_est[ia], gt[ib][:, 1:4])
            print(f"ATE RMSE: {err:.4f} m over {len(ia)} poses")
        else:
            print("ATE: too few associations with groundtruth")


if __name__ == "__main__":
    main()
