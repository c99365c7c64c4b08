"""Test configuration: JAX on a virtual 8-device CPU mesh.

Sharding logic is validated on host devices.  The platform defaults to
the CPU through JAX_PLATFORMS (set before JAX is imported); tests marked
``gpu`` need the card and are run by chip_smoke.py, in its own process,
where JAX has already chosen the GPU."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(777)  # reference default seed (nnet-randomizer.h:41)


@pytest.fixture
def gpu():
    """Skips unless JAX's default device is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {platform!r}")
