"""ydorbslam_tpu — a stereo/RGB-D visual SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of YDORBSLAM (an
ORB-SLAM2 reimplementation in C++): ORB pyramid extraction,
stereo/RGB-D frame tracking, covisibility-graph local mapping with local
bundle adjustment, descriptor-retrieval loop detection, Sim3 +
essential-graph correction, global BA, EPnP relocalization, and
TUM-format trajectory export.  It runs on an NVIDIA GPU, or on several
for the sharded parts.

Design principles (NOT a port):
  * All per-frame state is fixed-capacity arrays with validity masks —
    no dynamic shapes under jit.
  * The map is a struct-of-arrays (SoA) pytree of device arrays; graph
    updates are segment/scatter ops, not pointer surgery under mutexes.
  * Data association is dense masked Hamming search; the gated
    best/second search has a Triton kernel (ops/best2.py), everything
    else is plain jnp that XLA fuses.
  * Optimization (pose, local/global BA, Sim3 pose graph) is an analytic
    Levenberg–Marquardt with Schur complement in pure JAX, replacing g2o.
  * Multi-device scaling shards observations/map blocks over a
    jax.sharding.Mesh with psum-reduced normal equations, replacing the
    reference's thread+mutex concurrency.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Pose and BA estimation need full float32 matrix products: on the GPU
# the default precision may run f32 dots in TF32 (about three decimal
# digits), which moves LM and pose results.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; without it, compiled programs go to .jax_cache/ at the root of
# the checkout.  The path is fixed because it is part of the cache key.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
