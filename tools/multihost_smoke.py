#!/usr/bin/env python
"""2-process CPU smoke of the multi-host path (SURVEY.md §2c P6).

Spawns two processes that join one jax.distributed runtime over
localhost, build a process-spanning mesh through
parallel.multihost.device_mesh, and run (a) a psum over the
process-spanning axis and (b) the production keyframe-sharded retrieval
scoring against its dense single-device formulation: the same code as
on several hosts, with collectives crossing a process boundary (gloo on
the CPU standing in for the network between hosts).

Both ranks run with ``JAX_PLATFORMS=cpu`` and four host devices each:
the smoke stays off any GPU, so it can run beside a process that holds
the card.

Run:  python tools/multihost_smoke.py [--out PATH]
      writes the JSON result to PATH (default: a temp file — never the
      source tree)
"""
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main():
    import numpy as np
    import jax

    # Multi-process CPU needs an explicit collectives transport (gloo)
    # and per-process device count, set BEFORE the backend initializes.
    jax.config.update("jax_num_cpu_devices", 4)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from ydorbslam_tpu.parallel.multihost import (device_mesh,
                                                  initialize_distributed,
                                                  process_info)

    assert initialize_distributed(), "env contract not honored"
    info = process_info()
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 8, info

    # (a) psum across the process-spanning axis
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = device_mesh("kf")
    assert mesh is not None and mesh.devices.size == 8
    x = jnp.arange(8.0)
    xs = jax.device_put(x, NamedSharding(mesh, P("kf")))

    @jax.jit
    def total(v):
        return jnp.sum(v)

    with jax.sharding.use_mesh(mesh):
        s = float(total(xs))
    assert s == 28.0, s

    # (b) production sharded retrieval scoring == dense scoring
    from ydorbslam_tpu.parallel.retrieval_sharded import score_all_sharded
    from ydorbslam_tpu.slam.retrieval import (add_keyframe, bow_histogram,
                                              empty_index, score_all)

    rng = np.random.default_rng(0)
    K, N = 64, 128
    kw = dict(n_banks=4, bank_bits=10)
    idx = empty_index(K, **kw)
    for k in range(6):
        desc = jnp.asarray(rng.integers(0, 256, (N, 32), dtype=np.uint8))
        valid = jnp.ones((N,), bool)
        idx = add_keyframe(idx, k, desc, valid, **kw)
    q = bow_histogram(
        jnp.asarray(rng.integers(0, 256, (N, 32), dtype=np.uint8)),
        jnp.ones((N,), bool), **kw,
    )
    dense = np.asarray(score_all(idx, q))
    sharded = np.asarray(score_all_sharded(mesh, idx, q))
    assert np.allclose(dense, sharded, atol=1e-5), (
        np.abs(dense - sharded).max()
    )
    if info["process_index"] == 0:
        out = dict(ok=True, psum=s, processes=2, global_devices=8,
                   retrieval_max_abs_diff=float(np.abs(dense - sharded).max()))
        out_path = os.environ.get("YDORBSLAM_SMOKE_OUT")
        if not out_path:
            out_path = os.path.join(
                tempfile.gettempdir(), "ydorbslam_multihost_smoke.json"
            )
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        print("SMOKE OK", out, "->", out_path)


def parent_main():
    out_path = None
    if "--out" in sys.argv:
        out_path = sys.argv[sys.argv.index("--out") + 1]
    env_base = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        YDORBSLAM_COORDINATOR="127.0.0.1:8476",
        YDORBSLAM_NUM_PROCESSES="2",
    )
    if out_path:
        env_base["YDORBSLAM_SMOKE_OUT"] = out_path
    env_base.pop("XLA_FLAGS", None)
    procs = []
    for rank in range(2):
        env = dict(env_base, YDORBSLAM_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank"], env=env,
        ))
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=300))
    except Exception:
        codes.append("timeout")
    finally:
        # Never leave a sibling rank orphaned on failure/timeout.
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except Exception:
                    p.kill()
    if any(codes):
        print("FAILED", codes)
        sys.exit(1)
    print("multihost smoke passed")


if __name__ == "__main__":
    if "--rank" in sys.argv:
        rank_main()
    else:
        parent_main()
