"""Test configuration: the CPU backend with 8 virtual devices.

The unit suite pins JAX to the CPU (before any backend initialises) and
gives it 8 virtual devices, so the mesh tests have devices to shard over.
Tests that need an NVIDIA GPU carry the ``gpu`` marker and the ``gpu``
fixture, which skips them when the first device is not a GPU; on a card,
``python -m pytest -m gpu tests/`` leaves the platform to JAX and runs them.
"""
import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # The XLA CPU collective rendezvous ships a 40 s termination deadline:
    # if the 8 virtual-device threads miss it — which happens when other
    # jobs load the host's cores — XLA calls abort() and kills the whole
    # pytest process ("Termination timeout for `all reduce ...` of 40
    # seconds exceeded", rendezvous.cc).  Tests check correctness, not
    # latency; give the rendezvous 10 minutes.
    flags = (flags + " --xla_cpu_collective_call_terminate_timeout_seconds=600"
             " --xla_cpu_collective_call_warn_stuck_timeout_seconds=120").strip()
os.environ["XLA_FLAGS"] = flags

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    if (config.option.markexpr or "").strip() != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first JAX device, when it is an NVIDIA GPU; skips otherwise."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (first device is {device.platform}); "
                    "run on a card with: python -m pytest -m gpu tests/")
    return device
