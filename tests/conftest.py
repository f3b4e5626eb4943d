"""Test harness: force CPU with an 8-device virtual mesh.

N-device sharding semantics run on one host via
--xla_force_host_platform_device_count. Tests marked ``gpu`` need the
card; they skip here (the ``gpu`` fixture decides) and run on the card with
``MCPT_GPU_TESTS=1 python -m pytest -m gpu tests/``, which leaves the
platform to JAX.
"""

import os

GPU_RUN = os.environ.get("MCPT_GPU_TESTS") == "1"
if not GPU_RUN:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not GPU_RUN:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with MCPT_GPU_TESTS=1 on the card")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def cornell_scene():
    from monte_carlo_path_tracing_tpu.scene import load_scene

    path = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell", "cornell.obj")
    return load_scene(path)


@pytest.fixture(scope="session")
def veach_scene():
    from monte_carlo_path_tracing_tpu.scene import load_scene

    path = os.path.join(
        os.path.dirname(__file__), "..", "scenes", "veach-mis", "veach-mis.obj"
    )
    return load_scene(path)


@pytest.fixture()
def rng_np():
    return np.random.default_rng(1234)
