"""Row-binned 2D ESC engine (round 5): exact parity vs scipy.

The engine restructures the ESC pipeline around per-lane 2D sorts in place
of device-wide 1D sorts; these tests pin its
correctness on the CPU mesh in f64 across every regime: generic/symmetric,
long-B-row slicing, duplicate-run fallback, two-key (>2^31 output space),
planner fallbacks, and chunked row offsets.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from sparse_matrix_mult_tpu.ops.spgemm_binned import (
    binned_plan,
    spgemm_esc_binned,
)
from sparse_matrix_mult_tpu.types import bucket_capacity, from_scipy, to_scipy


def _run(A, B, symmetric=False, dtype=jnp.float64, window=8, lane_width=2048,
         row_offset=0, out_capacity=None):
    plan = binned_plan(
        A.indptr, A.indices, B.indptr, window=window, lane_width=lane_width
    )
    assert plan is not None
    a = from_scipy(A, dtype=dtype)
    b = from_scipy(B, dtype=dtype)
    oc = out_capacity or bucket_capacity(max(plan.n_partials, 1))
    c = spgemm_esc_binned(
        a,
        b,
        *plan.device_args(),
        window=plan.window,
        out_capacity=oc,
        symmetric=symmetric,
        row_offset=row_offset,
    )
    return to_scipy(c)


def _check(A, B, symmetric=False, **kw):
    got = _run(A, B, symmetric=symmetric, **kw)
    ref = (A @ B).toarray()
    if symmetric:
        ref = np.triu(ref)
    np.testing.assert_allclose(got.toarray(), ref, rtol=1e-12, atol=1e-13)
    return got


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize(
    "m,k,n,da,db,seed",
    [
        (64, 64, 64, 0.2, 0.2, 3),
        (100, 80, 100, 0.05, 0.3, 5),
        (120, 100, 120, 0.15, 0.15, 8),
        (10, 200, 10, 0.3, 0.02, 7),
    ],
)
def test_binned_matches_scipy(m, k, n, da, db, seed, symmetric):
    if symmetric and m != n:
        pytest.skip("symmetric needs square output")
    A = sp.random(m, k, density=da, format="csr", random_state=seed)
    B = sp.random(k, n, density=db, format="csr", random_state=seed + 1)
    _check(A, B, symmetric=symmetric)


def test_binned_long_b_rows_sliced():
    # B rows far wider than the window: slicing replaces the windowed
    # engine's tail machinery; exactness must hold for any skew.
    rng = np.random.default_rng(9)
    k, n = 40, 300
    B = sp.random(k, n, density=0.6, format="csr", random_state=10)  # ~180/row
    A = sp.random(50, k, density=0.2, format="csr", random_state=11)
    _check(A, B, window=8, lane_width=4096)
    _check(A, B, window=4, lane_width=4096)


def test_binned_duplicate_run_fallback():
    # Every A row references many B rows that share one column: the
    # longest possible duplicate (i, k) runs (= nnz of the A row) must be
    # summed exactly by the full-depth shifted-add network.
    k = 32
    rows, cols, vals = [], [], []
    for i in range(16):
        for j in range(k):
            rows.append(i); cols.append(j); vals.append(1.0 + 0.01 * j)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(16, k)).tocsr()
    B_cols = np.zeros(k, np.int64)  # every B row hits column 0
    B = sp.coo_matrix(
        (np.arange(1.0, k + 1), (np.arange(k), B_cols)), shape=(k, 8)
    ).tocsr()
    got = _check(A, B, window=2, lane_width=256)
    assert got.nnz == 16  # one fully-summed entry per row


def test_binned_structural_zeros_kept():
    # Gustavson structure: exact cancellations stay as explicit entries.
    A = sp.csr_matrix(np.array([[1.0, -1.0], [0.0, 2.0]]))
    B = sp.csr_matrix(np.array([[1.0, 0.0], [1.0, 0.0]]))
    got = _run(A, B)
    # (0,0) = 1 - 1 = 0 computed -> kept as structural zero
    assert got.nnz == 2
    assert got.indptr.tolist() == [0, 1, 2]
    np.testing.assert_allclose(got.toarray(), (A @ B).toarray())


def test_binned_two_key_beyond_int32():
    from sparse_matrix_mult_tpu.utils.testing import hypersparse_random

    m = 50_000  # m*n = 2.5e9 > 2**31 -> two-key lane sort
    A = hypersparse_random(m, m, 3000, seed=61)
    B = hypersparse_random(m, m, 3000, seed=62)
    got = _run(A, B, dtype=jnp.float64)
    ref = A @ B
    assert got.nnz == ref.nnz
    assert abs(got - ref).max() < 1e-10


def test_binned_row_offset_symmetric_chunks():
    # Chunked use: local row ids + row_offset keep the symmetric filter
    # globally correct (mirrors the other engines' contract).
    m = 60
    A = sp.random(m, m, density=0.1, format="csr", random_state=31)
    B = sp.random(m, m, density=0.1, format="csr", random_state=32)
    ref = np.triu((A @ B).toarray())
    half = m // 2
    parts = []
    for start, stop in [(0, half), (half, m)]:
        sub = A[start:stop]
        got = _run(sub, B, symmetric=True, row_offset=start)
        parts.append(got.toarray())
    np.testing.assert_allclose(np.vstack(parts), ref, rtol=1e-12, atol=1e-13)


def test_binned_plan_fallbacks():
    # A single output row whose padded volume exceeds one lane -> None.
    A = sp.csr_matrix(np.ones((4, 600)))
    B = sp.csr_matrix(np.ones((600, 4)))
    assert binned_plan(A.indptr, A.indices, B.indptr, lane_width=256) is None
    # Empty expansion -> None.
    E = sp.csr_matrix((5, 5))
    M = sp.random(5, 5, density=0.5, format="csr", random_state=1)
    assert binned_plan(M.indptr, M.indices, E.indptr) is None
    # Degenerate padding (pad ratio blown across multiple lanes) -> None:
    # two rows that each fill just over half a lane cannot share one, and
    # W=8 slices of 1-entry B rows pad 8x -> ratio test trips.
    A2 = sp.csr_matrix(np.ones((2, 300)))
    B2 = sp.csr_matrix(np.ones((300, 1)))
    plan = binned_plan(A2.indptr, A2.indices, B2.indptr, lane_width=4096)
    assert plan is None


def test_binned_f32():
    A = sp.random(100, 90, density=0.1, format="csr", random_state=41)
    B = sp.random(90, 110, density=0.1, format="csr", random_state=42)
    got = _run(A, B, dtype=jnp.float32)
    np.testing.assert_allclose(
        got.toarray(), (A @ B).toarray(), rtol=1e-5, atol=1e-6
    )


def test_binned_full_lane_then_empty_row_indptr():
    # Edge of the lane-local binary-search indptr: a lane packed to
    # exactly P live entries (no padding, no duplicates) followed by an
    # EMPTY row assigned to the same lane.  That row's lower_bound is P
    # itself, which the search can only reach with its first probe step
    # at P (a P/2 start caps lo at P-1 and corrupts indptr).
    W, Pl = 2, 8  # Wp = 4
    # A rows 0..3: one entry each, hitting B rows 0..3; B rows have
    # exactly W entries with distinct columns -> 4 virtual entries fill
    # lane 0 exactly (8 partials, zero padding, cnt = P).
    A = sp.coo_matrix(
        (np.ones(5), ([0, 1, 2, 3, 5], [0, 1, 2, 3, 4])), shape=(6, 5)
    ).tocsr()  # row 4 empty
    B = sp.coo_matrix(
        (
            np.arange(1.0, 11.0),
            (np.repeat(np.arange(5), 2), np.tile([0, 1], 5) + np.repeat(np.arange(5), 2)),
        ),
        shape=(5, 7),
    ).tocsr()  # every B row: 2 entries, distinct columns
    from sparse_matrix_mult_tpu.ops.spgemm_binned import binned_plan

    plan = binned_plan(A.indptr, A.indices, B.indptr, window=W, lane_width=Pl)
    assert plan is not None
    # the empty row 4 must live in the SAME (full) lane as rows 0..3
    assert plan.row_lane[4] == plan.row_lane[3]
    got = _run(A, B, window=W, lane_width=Pl)
    ref = (A @ B).toarray()
    np.testing.assert_allclose(got.toarray(), ref, rtol=1e-12, atol=1e-13)
    # indptr around the empty row: row 4 spans nothing, rows 0..3 carry
    # 2 entries each (distinct columns, no merges)
    assert got.indptr.tolist()[:6] == [0, 2, 4, 6, 8, 8]
