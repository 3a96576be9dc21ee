"""Test configuration: JAX on the CPU, as a virtual 8-device mesh.

The suite runs on the CPU (JAX_PLATFORMS=cpu unless the environment says
otherwise) with 8 virtual CPU devices for the sharding tests.  Tests that
need an NVIDIA GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them where JAX has no GPU; on the card run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

(``python chip_smoke.py`` covers the served path on the card).
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips where JAX has none)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("no GPU visible to JAX")
    return devs[0]
