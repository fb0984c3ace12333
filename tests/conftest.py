"""Test configuration.

Tests run on a virtual 8-device CPU mesh so data/model-parallel sharding is
exercised without several GPUs (chip_smoke.py --cards 4 runs the multi-device
paths on the cards).  The env vars must be set before jax initializes, hence
this top-of-conftest placement.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

# Tests run on the CPU: the parity tests need IEEE float64, the sharding
# tests the virtual 8-device mesh, and the Triton kernels run in the Pallas
# interpreter here.  Tests that need a GPU are marked `gpu` and skip.
jax.config.update("jax_platforms", "cpu")

from pathlib import Path

import pytest

assert jax.default_backend() == "cpu", jax.default_backend()
assert len(jax.devices()) == 8, jax.devices()

REFERENCE = Path("/root/reference")


@pytest.fixture(scope="session")
def reference_root() -> Path:
    if not REFERENCE.exists():
        pytest.skip("reference repo not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def perfil_dir(reference_root) -> Path:
    return reference_root / "test" / "test" / "perfil_data"


@pytest.fixture(scope="session")
def models_dir(reference_root) -> Path:
    return reference_root / "test" / "test" / "models"


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    A full-suite run accumulates hundreds of live XLA:CPU executables and
    eventually segfaults inside backend_compile (reproducible at the same
    test in two clean runs; the same tests pass standalone and in any
    small grouping).  Dropping caches at module boundaries keeps the
    JIT-state footprint bounded; per-module recompiles are already the
    norm since fixtures and shapes differ across modules."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()
