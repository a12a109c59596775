"""Test configuration: run the suite on a virtual 8-device CPU mesh.

JAX can emulate an N-device platform on CPU, which exercises the same
sharding/collective code paths a multi-GPU mesh uses.  On CPU, float64 is
native, so differential tests against scipy are exact-parity.

Set ``SMM_TESTS_ON_GPU=1`` to keep JAX's default backend instead, and run
the tests marked ``gpu`` on a card:
``SMM_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``.  Whether a ``gpu``
test skips is decided in the ``_gpu_only`` fixture, never at collection.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("SMM_TESTS_ON_GPU"):
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a GPU (run with SMM_TESTS_ON_GPU=1)")
    config.addinivalue_line("markers", "slow: long-running (large problem sizes)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") and jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
