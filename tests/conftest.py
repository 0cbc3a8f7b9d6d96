"""Test configuration: CPU backend, 8 virtual devices, float64 enabled.

Verification-grade numerics run in f64 (matching the reference's real*8);
the perf path uses f32 (see transport_se_tpu.config).  The virtual
8-device CPU mesh exercises the multi-device sharding path without cards.

Tests marked `gpu` need a card and skip elsewhere; on a machine with one
they run with `JAX_PLATFORMS=cuda python -m pytest tests -m gpu`.
"""

import os

import pytest

platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", platforms)
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (compiled kernels); skips elsewhere")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at test time,
    never at import: every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (JAX_PLATFORMS=cuda on a card)")
