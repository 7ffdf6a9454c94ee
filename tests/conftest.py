"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

The tests run on a host without a GPU; sharding is validated on
xla_force_host_platform_device_count=8 CPU devices, and the block kernel
runs in the Pallas interpreter (``interpret=True``).  The GPU run is
``python chip_smoke.py`` on the machine with the card.  Must run before the
first jax import.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

# Hold JAX to the CPU even where a GPU plugin is installed.
jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == 8, "tests expect an 8-device virtual CPU mesh"

import pathlib

import numpy as np
import pytest

from lbm_tpu.params import LBMParams

REFERENCE_ROOT = pathlib.Path("/root/reference")


def reference_available() -> bool:
    return REFERENCE_ROOT.is_dir()


requires_reference = pytest.mark.skipif(
    not reference_available(), reason="reference data not mounted"
)


@pytest.fixture
def small_params() -> LBMParams:
    """A tiny scene for fast unit tests."""
    return LBMParams(
        nx=16, ny=16, max_iters=10, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )


@pytest.fixture
def small_obstacles(small_params) -> np.ndarray:
    """Closed-box mask like the reference scenes: bottom/top rows and
    left/right columns blocked, plus one interior block."""
    ny, nx = small_params.ny, small_params.nx
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = True
    mask[-1, :] = True
    mask[:, 0] = True
    mask[:, -1] = True
    mask[5:7, 8:10] = True
    return mask
