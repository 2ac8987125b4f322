"""Test configuration.

The suite runs on the CPU unless ``JAX_PLATFORMS`` names another
platform: sharding is validated on a virtual 8-device CPU mesh (see
SURVEY.md §4: the multi-host test strategy the reference lacks
entirely).  Tests that need the GPU carry the ``gpu`` marker and take
the ``gpu`` fixture, which skips them elsewhere; ``chip_smoke.py`` runs
them on the card.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first JAX device, if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
    return dev
