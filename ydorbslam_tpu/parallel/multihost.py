"""Multi-host scaffolding: process-aware initialization + meshes.

The reference scales by threads inside one process
(src/system.cpp:52-61); here the scaling unit is a set of hosts: each
host drives its local GPUs, `jax.distributed.initialize` stitches the
processes into one runtime, and every `jax.devices()` call afterwards
returns the GLOBAL device list so jitted programs span hosts
transparently (XLA hands the collectives to NCCL, which uses NVLink
between the cards of a host and the network between hosts).

Design (SURVEY.md §2c P6):
- call :func:`initialize_distributed` once at process start (the apps
  do).  It is env-gated and a no-op single-process, so every existing
  single-host entry point keeps working unchanged.
- build meshes through :func:`device_mesh` — it uses the *global*
  device list and orders it process-major, so a sharded axis maps
  contiguous blocks to each host (the all-reduce in sharded BA then
  reduces over NVLink inside a host first and crosses the network once
  per host pair, instead of interleaving every edge over the network).
- keyframe-sharded retrieval and point-sharded BA
  (parallel/retrieval_sharded.py, parallel/ba_sharded.py) are written
  against a plain named mesh axis, so they run on a process-spanning
  mesh without modification.

Environment contract (one variable set => all three required):
  YDORBSLAM_COORDINATOR   host:port of process 0
  YDORBSLAM_NUM_PROCESSES total process count
  YDORBSLAM_PROCESS_ID    this process's rank
Standard JAX cluster auto-detection (e.g. SLURM) is used when available;
the explicit variables win.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

_initialized = False


def distributed_env() -> Optional[dict]:
    """The explicit coordinator spec from the environment, or None."""
    coord = os.environ.get("YDORBSLAM_COORDINATOR")
    if not coord:
        return None
    return dict(
        coordinator_address=coord,
        num_processes=int(os.environ["YDORBSLAM_NUM_PROCESSES"]),
        process_id=int(os.environ["YDORBSLAM_PROCESS_ID"]),
    )


def initialize_distributed() -> bool:
    """Join the multi-process runtime if configured; no-op otherwise.

    Returns True when running multi-process (after this call,
    ``jax.devices()`` is the global list and ``jax.process_count() > 1``).
    Safe to call more than once and safe single-process: the fallback
    path touches nothing, so tests and single-host apps are unaffected.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    spec = distributed_env()
    if spec is not None:
        jax.distributed.initialize(**spec)
        _initialized = True
        return True
    # Cluster managers (e.g. SLURM) expose the topology without explicit
    # addresses; initialize() auto-detects.  Guard with an env opt-in so
    # plain single-host runs never block on a coordinator.
    if os.environ.get("YDORBSLAM_AUTO_DISTRIBUTED") == "1":
        jax.distributed.initialize()
        _initialized = True
        return True
    _initialized = True
    return False


def device_mesh(axis_name: str, length_divisor: Optional[int] = None):
    """A 1-D process-major mesh over the GLOBAL device list.

    ``length_divisor``: when given, trim the device count to the
    largest value that divides it (sharded axes must tile exactly —
    e.g. max_keyframes for retrieval, the padded point count for BA).
    Returns None when no more than one usable device exists.

    Multi-process rule: every participating process must own at least
    one device of any mesh its programs execute on, so trimming may
    only drop WHOLE-HOST multiples (and never below the full host set)
    — cutting mid-host would leave a later rank with zero addressable
    mesh devices and deadlock the collective, and would also break the
    process-major "reduce inside the host first, one network hop" layout
    this mesh exists to provide.  When no whole-host count divides the
    axis, the caller gets None and takes its dense (replicated) fallback.
    """
    from jax.sharding import Mesh

    devs = list(jax.devices())
    # process-major order: all of host 0's cards, then host 1's ...
    devs.sort(key=lambda d: (getattr(d, "process_index", 0), d.id))
    n = len(devs)
    if length_divisor is not None:
        if jax.process_count() > 1:
            per_host = max(1, len(jax.local_devices()))
            if n != per_host * jax.process_count() or length_divisor % n:
                # Only the full process-spanning mesh keeps every rank
                # addressable; a non-dividing axis means no sharded mesh.
                return None
        else:
            while n > 1 and length_divisor % n:
                n -= 1
    if n <= 1:
        return None
    return Mesh(np.array(devs[:n]), (axis_name,))


def process_info() -> dict:
    """Observability: which slice of the world this process drives."""
    return dict(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=len(jax.local_devices()),
        global_devices=len(jax.devices()),
    )
