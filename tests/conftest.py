"""Test configuration.

The CPU backend gets 8 virtual devices, so the multi-device sharding paths
run without a cluster (the flag touches only the CPU backend). Runs before
jax is imported anywhere. The suite runs on the CPU with
`JAX_PLATFORMS=cpu`; tests marked `gpu` need the card and skip elsewhere
(`python -m pytest tests/ -m gpu` on a machine with one).
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, not at
    import, so every xdist worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
