"""Test harness setup.

Multi-device without hardware: 8 virtual CPU devices via
``--xla_force_host_platform_device_count=8`` — the JAX analogue of the
reference's ``mpirun --oversubscribe -np 4`` gtest wrapper
(reference: tests/CMakeLists.txt:10-17).

The CPU platform is pinned with a config update before any backend
initialization (``JAX_PLATFORMS=cpu`` does the same for subprocesses), and
the persistent compilation cache is off, in this process and the
subprocesses it starts, so test runs leave no cache in the checkout.

x64 is enabled globally: parity tests run in float64 on CPU, standing in for
the C++ reference oracle (SURVEY.md §4.4).
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _restore_x64():
    """run_simulation toggles jax_enable_x64 per cfg.precision (two-way);
    restore the suite's global f64 default after every test."""
    yield
    if not jax.config.read("jax_enable_x64"):
        jax.config.update("jax_enable_x64", True)


@pytest.fixture
def tmp_outputs_dir(tmp_path):
    d = tmp_path / "outputs"
    d.mkdir()
    return str(d)


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
