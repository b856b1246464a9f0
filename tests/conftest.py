"""Test configuration.

Tests run against the CPU backend with 8 virtual devices so all
sharding / multi-device code paths compile and execute without an
accelerator (mirrors the reference's CPU-only CI, reference
.github/workflows/unit-tests.yaml:9-27).  Pallas kernels run in
interpret mode, which the tests ask for explicitly.

``jax_default_device`` is pinned to the first CPU device so every
implicit device op stays on the CPU, while explicit multi-device tests
build their mesh from ``jax.devices("cpu")``.

Tests marked ``gpu`` need a GPU: the ``gpu_devices`` fixture skips
them when JAX finds none.  They run on the card in one process with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist``.
"""

import os

# Must be set before the CPU backend is first initialised; the GPU run
# sets JAX_PLATFORMS=cuda itself.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_default_device", jax.devices("cpu")[0])


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture(scope="session")
def gpu_devices():
    """The GPUs JAX sees; skips the test when there are none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run with -m gpu on the card)")
    return devices


@pytest.fixture(scope="session")
def blobs():
    """Clustered 2-d points, the reference's canonical quick E2E set
    (reference tests/test_examples.py:95-99)."""
    from sklearn.datasets import make_blobs

    X, y = make_blobs(centers=10, n_samples=1000, random_state=42)
    return X, y
