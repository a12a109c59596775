"""Both plain conversion paths against scipy, in float32 and float64.

``ops/convert.py`` has two forms of each conversion: the one-op XLA form
(scatter-add / ``nonzero(size=)``) below ``_SMALL`` dense elements, and the
shift networks above it.  Each test pins one path by setting ``_SMALL``.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from sparse_matrix_mult_tpu import from_scipy
from sparse_matrix_mult_tpu.ops import convert
from sparse_matrix_mult_tpu.ops.convert import csr_to_dense, dense_to_csr, dense_to_csr_triu

CASES = [
    # (rows, cols, density)
    (16, 300, 0.2),
    (37, 1000, 0.1),
    (8, 128, 0.0),  # all-zero
    (100, 513, 0.5),
    (5, 64, 1.0),  # fully dense
    (200, 200, 0.05),
    (63, 190, 0.3),
]

TRIU_CASES = [
    # (n, density)
    (40, 0.3),
    (130, 0.1),
    (64, 0.0),  # all-zero
    (96, 1.0),  # fully dense upper triangle
    (200, 0.07),
]

DTYPES = [np.float32, np.float64]


@pytest.fixture(params=["one_op", "network"])
def path(request, monkeypatch):
    monkeypatch.setattr(convert, "_SMALL", 1 << 40 if request.param == "one_op" else 0)
    return request.param


def _cap(nnz):
    return max(128, 1 << (max(nnz, 1) - 1).bit_length())


def _assert_packed(csr, ref):
    ip, ci, v = (np.asarray(x) for x in (csr.indptr, csr.indices, csr.values))
    nnz = ip[-1]
    assert nnz == ref.nnz
    np.testing.assert_array_equal(ip, ref.indptr)
    np.testing.assert_array_equal(ci[:nnz], ref.indices)
    np.testing.assert_array_equal(v[:nnz], ref.data)
    # Padding contract: zeros past nnz.
    assert np.all(v[nnz:] == 0)
    assert np.all(ci[nnz:] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,d", CASES)
def test_dense_to_csr_matches_scipy(m, n, d, dtype, path):
    a = sp.random(m, n, density=d, format="csr", random_state=1)
    dense = a.toarray().astype(dtype)
    ref = sp.csr_matrix(dense)
    ref.eliminate_zeros()
    _assert_packed(dense_to_csr(jnp.asarray(dense), _cap(ref.nnz)), ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,d", CASES)
def test_csr_to_dense_roundtrip(m, n, d, dtype, path):
    a = sp.random(m, n, density=d, format="csr", random_state=2)
    dev = from_scipy(a, dtype=dtype)
    back = np.asarray(csr_to_dense(dev))
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, a.toarray().astype(dtype))
    again = dense_to_csr(jnp.asarray(back), dev.capacity)
    np.testing.assert_array_equal(np.asarray(csr_to_dense(again)), back)


@pytest.mark.parametrize("n,d", TRIU_CASES)
def test_dense_to_csr_triu_staircase(n, d, path):
    a = sp.random(n, n, density=d, format="csr", random_state=4)
    dense = np.triu(a.toarray().astype(np.float32))
    ref = sp.csr_matrix(dense)
    ref.eliminate_zeros()
    _assert_packed(dense_to_csr_triu(jnp.asarray(dense), _cap(ref.nnz)), ref)
