"""Native host Gustavson SpGEMM (the small-problem escape hatch).

Differential tests against scipy for the two-phase OpenMP kernel in
``native/csr_host.cpp`` (``smm_spgemm_count``/``smm_spgemm_fill``) plus the
API routing that sends tiny problems there instead of paying a device
dispatch (reference analogue: its serial-mode guidance,
``/root/reference/README.md:16-17``).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import sparse_matrix_mult_tpu as smm
from sparse_matrix_mult_tpu.utils.native import get_native, spgemm_host


@pytest.mark.parametrize("m,k,n,density", [
    (50, 40, 60, 0.2),
    (200, 200, 200, 0.05),
    (1000, 1000, 1000, 0.01),
    (3, 7, 5, 0.9),
])
@pytest.mark.parametrize("symmetric", [False, True])
def test_spgemm_host_matches_scipy(m, k, n, density, symmetric):
    if symmetric and m != n:
        pytest.skip("symmetric output requires square product")
    A = sp.random(m, k, density=density, format="csr", random_state=m + n)
    B = sp.random(k, n, density=density, format="csr", random_state=m + n + 1)
    out = spgemm_host(A, B, symmetric=symmetric)
    ref = (A @ B).toarray()
    if symmetric:
        ref = np.triu(ref)
    np.testing.assert_allclose(out.toarray(), ref, rtol=1e-12, atol=1e-14)
    # Both branches (native OpenMP kernel and the small-problem scipy branch)
    # honor the sorted-column-indices contract of the host route.
    for r in range(min(m, 64)):
        seg = out.indices[out.indptr[r] : out.indptr[r + 1]]
        assert np.all(np.diff(seg) > 0)


def test_spgemm_host_empty_rows_and_cols():
    A = sp.csr_matrix((np.array([2.0]), np.array([3]), np.array([0, 0, 1, 1])),
                      shape=(3, 5))
    B = sp.random(5, 4, density=0.5, format="csr", random_state=7)
    out = spgemm_host(A, B)
    np.testing.assert_allclose(out.toarray(), (A @ B).toarray())


def test_native_kernel_present():
    lib = get_native()
    assert lib is not None, "native host library should build in this checkout"
    assert getattr(lib, "smm_spgemm_count", None) is not None


@pytest.mark.parametrize("output_format", ["sparse", "dense"])
def test_api_routes_tiny_to_host(output_format):
    A = sp.random(300, 300, density=0.01, format="csr", random_state=1)
    B = sp.random(300, 300, density=0.01, format="csr", random_state=2)
    ref = (A @ B).toarray()
    got = smm.sparse_matrix_multiply(A, B, output_format=output_format)
    assert smm.get_last_route() == "host"
    got_d = got.toarray() if sp.issparse(got) else got
    np.testing.assert_allclose(got_d, ref, rtol=1e-12, atol=1e-14)


def test_api_host_route_symmetric():
    A = sp.random(200, 200, density=0.02, format="csr", random_state=3)
    B = sp.random(200, 200, density=0.02, format="csr", random_state=4)
    got = smm.sparse_matrix_multiply(A, B, symmetric=True)
    assert smm.get_last_route() == "host"
    np.testing.assert_allclose(
        got.toarray(), np.triu((A @ B).toarray()), rtol=1e-12, atol=1e-14
    )


def test_api_large_routes_to_device_on_fast_link():
    """With the link pinned to PCIe-class parameters (no auto-calibration)
    the cost model must send 500^2 d=0.3 to a device route.  On a slow
    link the same call legitimately routes to host -- routing is a
    calibrated scheduler decision, not a universal constant -- so the link
    is pinned here to make the assertion backend-independent."""
    from sparse_matrix_mult_tpu.config import get_config, set_config

    old = get_config()
    set_config(
        auto_calibrate_link=False,
        link_fixed_s=2e-3,
        link_up_bytes_per_s=8e9,
        link_down_bytes_per_s=8e9,
    )
    try:
        A = sp.random(500, 500, density=0.3, format="csr", random_state=5)
        B = sp.random(500, 500, density=0.3, format="csr", random_state=6)
        smm.sparse_matrix_multiply(A, B)
        assert smm.get_last_route() in ("dense", "esc", "esc_windowed", "esc_binned")
    finally:
        set_config(old)


def test_api_routes_to_host_on_slow_link():
    """Same problem, link pinned to a slow network-attached device (~25 ms
    dispatch, ~30 MB/s fetch): the cost model must choose the host route."""
    from sparse_matrix_mult_tpu.config import get_config, set_config

    old = get_config()
    set_config(
        auto_calibrate_link=False,
        link_fixed_s=25e-3,
        link_up_bytes_per_s=100e6,
        link_down_bytes_per_s=30e6,
    )
    try:
        A = sp.random(500, 500, density=0.3, format="csr", random_state=5)
        B = sp.random(500, 500, density=0.3, format="csr", random_state=6)
        got = smm.sparse_matrix_multiply(A, B)
        assert smm.get_last_route() == "host"
        np.testing.assert_allclose(
            got.toarray(), (A @ B).toarray(), rtol=1e-12, atol=1e-14
        )
    finally:
        set_config(old)
