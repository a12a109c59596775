"""Transfer layer: chunked fetch, fine capacity buckets, dense->CSR pack.

These guard the scipy-out download path (types.to_scipy fine trimming,
utils/transfer chunked fetch + host pack).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from sparse_matrix_mult_tpu.types import from_scipy, to_scipy
from sparse_matrix_mult_tpu.utils.native import dense_pack
from sparse_matrix_mult_tpu.utils.transfer import (
    fetch_dense_to_csr,
    fetch_np,
    fine_capacity,
)


def test_fine_capacity_slack_and_variants():
    for n in [1, 100, 1000, 12345, 10_000_000, (1 << 26) - 1]:
        f = fine_capacity(n)
        assert f >= max(n, 128)
        assert f <= max(n, 128) * (1 + 1 / 16) + 1
    # Bounded distinct shapes per octave.
    octave = {fine_capacity(n) for n in range(1 << 20, 1 << 21, 257)}
    assert len(octave) <= 33


@pytest.mark.parametrize("shape", [(100,), (5_000_000,), (3000, 1500), (7, 3)])
def test_fetch_np_roundtrip(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    d = jnp.asarray(x)
    np.testing.assert_array_equal(fetch_np(d), x)


@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 1.0])
def test_fetch_dense_to_csr_matches_scipy(density):
    rng = np.random.default_rng(1)
    d = rng.standard_normal((2100, 1700)).astype(np.float32)
    d[rng.random(d.shape) >= density] = 0
    got = fetch_dense_to_csr(jnp.asarray(d))
    ref = sp.csr_matrix(d.astype(np.float64))
    assert got.shape == ref.shape
    assert got.nnz == ref.nnz
    assert (got != ref).nnz == 0
    assert got.dtype == np.float64


def test_dense_pack_edge_cases():
    # Empty matrix, empty rows, single element.
    for d in [
        np.zeros((5, 4), np.float32),
        np.array([[0, 1, 0], [0, 0, 0], [2, 0, 3]], np.float32),
        np.array([[7.0]], np.float64),
    ]:
        got = dense_pack(d)
        ref = sp.csr_matrix(d.astype(np.float64))
        assert (got != ref).nnz == 0
        assert got.dtype == np.float64


def test_api_full_triu_values_only_download():
    """Symmetric products that are 100% dense in the upper triangle take
    the values-only staircase download (indices rebuilt on host)."""
    import scipy.sparse as sp

    import sparse_matrix_mult_tpu as smm
    from sparse_matrix_mult_tpu.config import get_config, set_config

    n = 2100  # n*n > host_extract_limit so the small-panel path stays off
    A = sp.random(n, n, density=0.35, format="csr", random_state=41)
    B = sp.random(n, n, density=0.35, format="csr", random_state=42)
    old = get_config()
    set_config(
        auto_calibrate_link=False,
        link_fixed_s=1e-5,
        link_up_bytes_per_s=8e9,
        link_down_bytes_per_s=8e9,
        host_rate_base=1e3,  # force the device route
        host_compute_limit=0,
    )
    try:
        got = smm.sparse_matrix_multiply(A, B, symmetric=True)
        assert smm.get_last_route() == "dense"
        ref = sp.triu(A @ B).tocsr()
        assert got.nnz == ref.nnz == n * (n + 1) // 2  # fully dense triu
        ref.sort_indices()
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_allclose(got.data, ref.data, rtol=1e-5, atol=1e-8)
    finally:
        set_config(old)


def test_to_scipy_fine_trim_roundtrip():
    # nnz chosen so the power-of-two capacity has ~2x slack and the fine
    # bucket engages.  Structure and f64 values must round-trip exactly.
    m = sp.random(2000, 2000, density=0.14, format="csr", random_state=3)
    rt = to_scipy(from_scipy(m))
    assert rt.nnz == m.nnz
    np.testing.assert_array_equal(rt.indptr, m.indptr)
    np.testing.assert_array_equal(rt.indices, m.indices)
    np.testing.assert_array_equal(rt.data, m.data.astype(rt.dtype))
