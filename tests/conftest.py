"""Test configuration: CPU backend, f64, 8 virtual devices for sharding tests.

Mirrors the reference's CI strategy (SURVEY.md §4): distributed correctness
is checked by partition invariance on an oversubscribed single host
(`mpirun -n 2|4` there; an 8-device virtual CPU mesh here).

Tests marked ``gpu`` need an NVIDIA GPU.  ``python -m pytest tests -m gpu``
runs exactly those, without the CPU pin; anywhere else the ``gpu`` marker
makes them skip (decided by the fixture below, never at import).
"""

import os

import jax
import pytest

# an ArcaneFEM checkout for the golden-file tests; they skip without one
REFERENCE = os.environ.get("ARCANEFEM_REFERENCE", "")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run with -m gpu on the card)")
    if config.option.markexpr != "gpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # the precision policy of utils/device.setup
    jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if request.node.get_closest_marker("gpu") is not None:
        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs an NVIDIA GPU; JAX runs on {platform}")


@pytest.fixture(scope="session")
def reference_dir():
    if not REFERENCE:
        pytest.skip("needs an ArcaneFEM checkout; set ARCANEFEM_REFERENCE")
    if not os.path.isdir(REFERENCE):
        pytest.skip(f"ARCANEFEM_REFERENCE={REFERENCE} is not a directory")
    return REFERENCE
