"""Test harness config.

By default the suite runs on the CPU backend with 8 virtual devices, so
multi-device sharding tests run anywhere (the rebuild's analog of the
reference's single-host gtest binaries plus device-count-gated tests).
`chip_smoke.py` runs the `gpu`-marked tests in its own process on the
card it already holds, passing `--gpu`; then nothing here touches the
platform. The platform is set in `pytest_configure`, before any test
module imports JAX, and is the same for every xdist worker."""

import os
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def pytest_addoption(parser):
    parser.addoption(
        "--gpu",
        action="store_true",
        help="run on the already-initialized default backend (chip_smoke.py) "
        "instead of forcing 8 virtual CPU devices",
    )


def pytest_configure(config):
    if config.getoption("--gpu"):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.device_count() >= 8, (
        f"expected 8 virtual CPU devices, got {jax.device_count()} "
        f"on {jax.devices()[0].platform}"
    )


@pytest.fixture
def gpu():
    """The GPU the `gpu`-marked tests run on; skips anywhere else."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return dev
