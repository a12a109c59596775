"""The main routes on a GPU, checked against scipy in float64.

Marked ``gpu``: they skip on the CPU and run on a card with
``SMM_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``.  The scipy entry
point is pinned to its device routes, as it is at real sizes.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import sparse_matrix_mult_tpu as smm
from sparse_matrix_mult_tpu.ops.triu_matmul import matmul_triu
from sparse_matrix_mult_tpu.utils.testing import hypersparse_random

pytestmark = pytest.mark.gpu

# The reference's oracle (tests/test_basic.py:54).
RTOL, ATOL = 1e-5, 1e-8


@pytest.fixture
def device_routes():
    old = smm.get_config()
    smm.set_config(auto_calibrate_link=False, host_compute_limit=0, host_rate_base=1e3)
    yield
    smm.set_config(old)


@pytest.mark.parametrize("symmetric", [False, True])
def test_dense_route_matches_scipy(device_routes, symmetric):
    a = sp.random(2000, 2000, density=0.05, format="csr", random_state=1)
    b = sp.random(2000, 2000, density=0.05, format="csr", random_state=2)
    got = smm.sparse_matrix_multiply(a, b, symmetric=symmetric)
    assert smm.get_last_route() == "dense"
    ref = (a @ b).toarray()
    want = np.triu(ref) if symmetric else ref
    np.testing.assert_allclose(got.toarray(), want, rtol=RTOL, atol=ATOL)


def test_binned_esc_route_matches_scipy(device_routes):
    a = hypersparse_random(20_000, 20_000, 80_000, seed=3)
    b = hypersparse_random(20_000, 20_000, 80_000, seed=4)
    got = smm.sparse_matrix_multiply(a, b)
    assert smm.get_last_route() == "esc_binned"
    np.testing.assert_allclose(got.toarray(), (a @ b).toarray(), rtol=RTOL, atol=ATOL)


def test_triangular_product_fast_meets_oracle():
    """float32 operands at precision='highest' stay inside the oracle."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(3000, 3000))
    y = rng.uniform(size=(3000, 3000))
    got = matmul_triu(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), block=512)
    np.testing.assert_allclose(np.asarray(got), np.triu(x @ y), rtol=RTOL, atol=ATOL)
