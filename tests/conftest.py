"""Test configuration: 8 virtual CPU devices so sharding/collective logic
is exercised without accelerator hardware (SURVEY.md §4 item 4). Run the
suite on the CPU with JAX_PLATFORMS=cpu.

Tests marked `gpu` need an NVIDIA GPU: the `gpu_device` fixture decides
at run time (never at import or collection, so every xdist worker
collects the same tests) and skips them elsewhere. The README names the
command that runs them on a GPU machine."""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture()
def gpu_device():
    """The first GPU, or a skip when JAX's backend has none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX backend is "
                    f"{dev.platform!r})")
    return dev
