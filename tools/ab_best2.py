"""End-to-end A/B of the best2 Triton kernel against its XLA reference,
and one profiled window of the RGB-D main phase, on one GPU.

    python tools/ab_best2.py --out DIR

1. Runs chip_smoke.py's RGB-D main phase (pipelined, default
   CapacityConfig) four times in one process, kernel and XLA in turns
   (kernel, XLA, XLA, kernel).  After each pass it times mapping_prep on
   the pass's final map: six dispatches chained, one sync.
2. Traces a 30-frame window of the same phase with the kernel and
   reduces the trace to device time per jitted program
   (rgbd_frame_step, mapping_prep, mapping_finish, ...), device busy
   time and the idle share of the window.

XLA runs each program's kernels as one command buffer (a CUDA graph) by
default, so the trace shows one event per program launch, not one per
fusion: the reduction is per program.  Writes DIR/ab.json and
DIR/trace_summary.json; the raw trace goes to build/ in the checkout.
"""
import argparse
import collections
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ab_passes(cs, b2, jax, jnp):
    from ydorbslam_tpu.slam.mapping import mapping_prep

    res = []
    for variant in ("kernel", "xla", "xla", "kernel"):
        b2.use_kernel = (lambda: True) if variant == "kernel" else (
            lambda: False)
        jax.clear_caches()
        t0 = time.perf_counter()
        keep = []
        ok, out = cs.rgbd_phase(cs.CompileCounter(), keep=keep)
        s = keep[0]
        o = s.cfg.orb

        def prep(m):
            return mapping_prep(
                m, jnp.int32(s.ref_kf), jnp.int32(s.n_keyframes), s.cam,
                scale_factor=o.scale_factor, n_levels=o.n_levels,
                **s._prep_kw,
            ).mp_pos

        maps = [jax.tree.map(jnp.copy, s.map) for _ in range(7)]
        jax.block_until_ready(prep(maps[0]))
        jax.block_until_ready(maps[-1].mp_pos)
        t1 = time.perf_counter()
        last = [prep(m) for m in maps[1:]][-1]
        jax.block_until_ready(last)
        out.update(variant=variant, ok=ok, wall_s=time.perf_counter() - t0,
                   mapping_prep_chained_ms=(time.perf_counter() - t1) / 6e-3)
        print("AB", json.dumps(out), flush=True)
        res.append(out)
        del maps, last, keep, s
    return res


def reduce_trace(trace_dir, window_ns, n_frames):
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    lines_seen = collections.Counter()
    events = []  # (line, module, start, end)
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = {k: str(v) for k, v in ev.stats}
                lines_seen[f"{plane.name}|{line.name}"] += ev.duration_ns
                events.append((line.name, st.get("hlo_module", "?"),
                               ev.start_ns, ev.start_ns + ev.duration_ns))
    # Device work sits on the per-stream lines ("Stream #13(Compute)");
    # any other line is derived from them and would count it twice.
    kern = [e for e in events if e[0].startswith("Stream")]
    per_mod = collections.Counter()
    for _, mod, a, b in kern:
        per_mod[mod] += b - a
    busy, cur = 0.0, None
    for a, b in sorted((e[2], e[3]) for e in kern):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    step_ns = sum(v for mod, v in per_mod.items() if "rgbd_frame_step" in mod)
    return dict(
        lines_ms={k: v / 1e6 for k, v in lines_seen.most_common(12)},
        frames=n_frames, window_ms=window_ns / 1e6,
        device_busy_ms=busy / 1e6, idle_share_of_window=1 - busy / window_ns,
        rgbd_frame_step_ms_per_frame=step_ns / 1e6 / n_frames,
        per_module_ms={k: v / 1e6 for k, v in per_mod.most_common(15)},
    )


def traced_window(cs, b2, jax, n_warm=30, n_traced=30):
    from ydorbslam_tpu.slam.system import SlamSystem, Sensor

    b2.use_kernel = lambda: True
    jax.clear_caches()
    cfg, frames, _ = cs.rgbd_setup(n_warm + n_traced)
    s = SlamSystem(cfg, Sensor.RGBD, enable_loop_closing=False)
    s.enable_pipelined(lag=16)
    s.precompile()
    for t, g, d in frames[:n_warm]:
        s.track_rgbd_pipelined(t, g, d)
    s.flush_pipeline()
    jax.block_until_ready(s.map.mp_pos)
    kf0 = s.n_keyframes
    trace_dir = os.path.join(ROOT, "build", "ab_best2", "trace")
    jax.profiler.start_trace(trace_dir)
    t0 = time.perf_counter()
    for t, g, d in frames[n_warm:]:
        s.track_rgbd_pipelined(t, g, d)
    s.flush_pipeline()
    jax.block_until_ready(s.map.mp_pos)
    window_ns = (time.perf_counter() - t0) * 1e9
    jax.profiler.stop_trace()
    summary = reduce_trace(trace_dir, window_ns, n_traced)
    summary["keyframes_in_window"] = s.n_keyframes - kf0
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="output directory")
    args = ap.parse_args()
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    sys.path.insert(0, ROOT)

    import chip_smoke as cs

    import jax
    import jax.numpy as jnp

    import ydorbslam_tpu  # noqa: F401  (precision and compile cache)
    from ydorbslam_tpu.ops import best2 as b2

    if jax.devices()[0].platform != "gpu":
        sys.exit("ab_best2: needs a GPU")
    print("card:", cs.card_info(), flush=True)
    res = ab_passes(cs, b2, jax, jnp)
    with open(os.path.join(out_dir, "ab.json"), "w") as f:
        json.dump(res, f, indent=1)
    summary = traced_window(cs, b2, jax)
    summary["card"] = cs.card_info()
    print("TRACE", json.dumps(summary), flush=True)
    with open(os.path.join(out_dir, "trace_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
