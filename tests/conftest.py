"""Test configuration: x64 on, and 8 virtual CPU devices for the mesh tests.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``); multi-device sharding
is validated on virtual CPU devices (``xla_force_host_platform_device_count``).
Tests marked ``gpu`` need the card: they skip elsewhere, and run on the GPU
with ``python -m pytest -m gpu tests/test_gpu.py``.  ``chip_smoke.py`` drives the
whole main path on the GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided per test, never at import time."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX runs on {device.platform}")
    return device
