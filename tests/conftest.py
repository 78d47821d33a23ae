"""Test harness: the CPU backend with 8 virtual devices (the multi-chip fake).

Mirrors the reference's strategy of deterministic, real-implementation tests
(SURVEY.md §4.5); sharding tests use the virtual device mesh the way the
reference CI uses QEMU as its fake backend.  Test oracles compute matmuls at
HIGHEST precision.

``VDB_TEST_DEVICE=gpu`` leaves JAX on its default backend instead: that is
how `chip_smoke.py` runs the tests marked ``gpu`` on the card (they skip on
the CPU).

Must run before any `import jax` anywhere in the test session.
"""

import os

ON_DEVICE = os.environ.get("VDB_TEST_DEVICE", "cpu") == "gpu"

if not ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_default_matmul_precision", "highest")

from vector_db_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.1)

import numpy as np
import pytest


@pytest.fixture
def rng():
    """Fixed seed 42, like every reference test (SURVEY.md §4.5)."""
    return np.random.default_rng(42)


@pytest.fixture
def tmp_store_path(tmp_path):
    return str(tmp_path / "vdb")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU.  Decided here, when the
    test runs, so every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run chip_smoke.py on the card)")
    return jax.devices()[0]
