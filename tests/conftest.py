"""Test configuration: CPU backend with 8 virtual devices.

Multi-device sharding paths are validated the way the reference validates
multi-host paths without a cluster (SURVEY.md §4): here by simulating an
8-device mesh on CPU via ``xla_force_host_platform_device_count``.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which decides at run time (never at import or collection) whether
a card is present; here, on the CPU, they skip.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# CPU unless the command names a platform (the GPU tests run with
# JAX_PLATFORMS=cuda,cpu)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# no persistent XLA cache under tests: CPU compiles are cheap, and cached
# CPU executables can trip host feature-mismatch loads
os.environ["JAX_COMPILATION_CACHE_DIR"] = ""

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided when the test runs."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (on the card: "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)")
    return gpus[0]
