"""Test configuration.

Tests run on the CPU backend with 8 virtual devices, so multi-device
sharding logic is exercised without accelerators (SURVEY §4: the reference
has no test layer at all; we test against a pure-NumPy oracle).  On the CPU
the library runs its plain XLA paths; the Triton kernels are tested here in
interpret mode against those paths and the oracle.

Tests marked ``gpu`` need the card and skip here; ``chip_smoke.py`` runs
what they check on the GPU, and ``HUFFMAN_TEST_PLATFORM=gpu pytest -m gpu``
runs them there directly (see README).
"""

import os

_platform = os.environ.get("HUFFMAN_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Plugins may import jax before this conftest runs, so the env var alone is
# read too late; override through the config API as well.
import jax

jax.config.update("jax_platforms", _platform)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (skips on the CPU; chip_smoke.py "
        "runs these checks on the card)",
    )


@pytest.fixture
def gpu():
    """Skip unless a GPU is the default backend (decided at run time, never
    at import, so every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this on the card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
