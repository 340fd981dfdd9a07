"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device hardware isn't available in CI; sharding correctness is
validated on host-platform virtual devices.  The platform is pinned with
jax.config.update before any backend initializes (backends initialize
lazily at first jax.devices()), so the suite runs on the CPU even in a
process that has a GPU, unless CORTICALL_TESTS_ON_DEVICE=1.

Tests marked `gpu` need a GPU and skip on the CPU with a reason; whether a
GPU is present is decided inside the `gpu_device` fixture, never at import
or collection time, so every xdist worker collects the same tests.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

if os.environ.get("CORTICALL_TESTS_ON_DEVICE") != "1":
    import jax
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_TESTDATA = "/root/reference/testdata"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips with a reason on the CPU")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when the backend has none."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with CORTICALL_TESTS_ON_DEVICE=1 "
                    "on a machine with one)")
    return jax.devices()[0]
