"""Test session setup.

The tests run on JAX's CPU backend unless ``JAX_PLATFORMS`` is already set,
with 8 virtual CPU devices for the sharding tests.  Both settings must be
in the environment before JAX initializes a backend, which happens at the
first device use, after this file is loaded.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them elsewhere.  On a machine with a card:
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: anything not marked ``slow`` is the quick gate.
    ``pytest -m quick`` validates a change in under ~2 minutes; the slow
    tier holds the compile-heavy engine/fuzz/driver/sharding tests."""
    for item in items:
        if item.get_closest_marker("slow") is None:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test when there is none (decided
    when the test runs, never at import)."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu)")
