"""Force tests onto a virtual 8-device CPU mesh (no TPU needed in CI).

A pytest plugin imports jax before this conftest runs, and the machine env
pins JAX_PLATFORMS to the TPU plugin — so setting env vars alone is not
enough; jax.config.update must override before any backend initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


def pytest_sessionstart(session):
    # fail fast if the backend ended up on the TPU anyway
    assert jax.default_backend() == "cpu", jax.devices()


@pytest.fixture(autouse=True)
def _seed_numpy():
    np.random.seed(0)
    yield
