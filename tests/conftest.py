"""Test configuration: a local 8-device CPU mesh + float64.

Unit tests need the CPU backend (tight float64 oracles + an 8-device
simulated mesh for the shard_map distributed tests, SURVEY.md §4.3),
so the platform is pinned to CPU unless JAX_PLATFORMS names another.
Tests marked `gpu` need an NVIDIA GPU and skip elsewhere; on the card
run them with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(__file__))  # for `import oracle`


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
