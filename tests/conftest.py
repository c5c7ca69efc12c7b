"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-chip sharding tests use CPU-simulated devices per
``XLA_FLAGS=--xla_force_host_platform_device_count``; kernels are
platform-agnostic (no TPU needed for correctness tests).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the session env may point at TPU
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402,F401  (import after env is set)

# some TPU plugins self-register regardless of JAX_PLATFORMS; this wins
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    A full-suite run accumulates every module's jitted programs in one
    process; the big interpret-mode Pallas compilations late in the
    alphabet (test_pallas_exact_duplex) then segfault XLA's CPU compiler
    under the memory pressure.  Per-module cache clearing keeps the
    process bounded; per-module compile reuse is unaffected."""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
