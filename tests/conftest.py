"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding is validated without accelerator hardware the standard
JAX way -- ``xla_force_host_platform_device_count`` -- which is this
framework's equivalent of the reference's 'flat metric' fake backend for
precise comparisons (reference README.md:233).  Tests that need a GPU take
the ``gpu`` fixture (marker ``gpu``), which skips them here.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from blackhole_geodesic_calculator_tpu.utils import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at run time, never at import,
    so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest -m gpu` on the card")
    return jax.devices()[0]
