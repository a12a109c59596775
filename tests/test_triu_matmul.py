"""Tests for the upper-triangular product and its dispatch wiring."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from sparse_matrix_mult_tpu import from_scipy
from sparse_matrix_mult_tpu.ops import dense_path, triple_product, triu_matmul
from sparse_matrix_mult_tpu.ops.triu_matmul import matmul_triu

_TOL = {np.float32: dict(rtol=1e-4, atol=1e-4), np.float64: dict(rtol=1e-12, atol=1e-11)}


def _operands(m, k, transpose_b, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(dtype)
    b = rng.standard_normal((m, k) if transpose_b else (k, m)).astype(dtype)
    return a, b


def _check(m, k, transpose_b, dtype, **kw):
    a, b = _operands(m, k, transpose_b, dtype, m + k)
    got = np.asarray(matmul_triu(jnp.asarray(a), jnp.asarray(b), transpose_b=transpose_b, **kw))
    ref = np.triu(a.astype(np.float64) @ (b.T if transpose_b else b).astype(np.float64))
    assert got.shape == ref.shape
    assert got.dtype == dtype
    np.testing.assert_array_equal(np.tril(got, -1), 0)
    np.testing.assert_allclose(got, ref, **_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("m,k", [(300, 500), (256, 256), (100, 700)])
def test_matmul_triu_matches_numpy(m, k, transpose_b, dtype):
    _check(m, k, transpose_b, dtype, block=64)


@pytest.mark.parametrize("m,k,block", [(257, 31, 64), (1000, 70, 128), (129, 5, 128), (77, 13, 16)])
def test_matmul_triu_odd_sizes(m, k, block):
    _check(m, k, False, np.float64, block=block)


@pytest.mark.parametrize("m,k", [(5, 7), (64, 100)])
def test_matmul_triu_below_recursion_cutoff(m, k):
    _check(m, k, True, np.float64)


@pytest.mark.parametrize("m,k", [(100, 2000), (300, 1)])
def test_matmul_triu_rectangular_k(m, k):
    _check(m, k, False, np.float64, block=64)


def _dot_flops(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    total = 0
    for eqn in jaxpr.jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (m, k), (_, n) = (v.aval.shape for v in eqn.invars)
            total += 2 * m * k * n
    return total


def test_matmul_triu_flop_fraction():
    """Depth d does 1/2 + 1/2**(d+1) of the full product's flops."""
    n, k = 512, 8
    x = jnp.ones((n, k))
    y = jnp.ones((k, n))
    full = 2 * n * k * n
    for block, depth in [(512, 0), (256, 1), (128, 2), (64, 3)]:
        got = _dot_flops(lambda a, b: matmul_triu(a, b, block=block), x, y)
        assert got == full * (0.5 + 0.5 ** (depth + 1))


def test_matmul_triu_rejects_non_square():
    with pytest.raises(ValueError):
        matmul_triu(jnp.ones((3, 4)), jnp.ones((4, 5)))


def test_symmetric_spgemm_via_triu_kernel(monkeypatch):
    """spgemm_dense_out(symmetric=True) runs the triangular product."""
    monkeypatch.setattr(triu_matmul, "_BLOCK", 64)
    calls = []
    real = dense_path.matmul_triu

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(dense_path, "matmul_triu", spy)
    a_sp = sp.random(260, 300, density=0.1, format="csr", random_state=1)
    b_sp = sp.random(300, 260, density=0.1, format="csr", random_state=2)
    ref = np.triu((a_sp @ b_sp).toarray())
    for dtype, prec, tol in [(jnp.float32, "fast", 1e-5), (jnp.float64, None, 1e-12)]:
        a = from_scipy(a_sp, dtype=dtype)
        b = from_scipy(b_sp, dtype=dtype)
        got = np.asarray(dense_path.spgemm_dense_out(a, b, symmetric=True, precision=prec))
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    assert calls


def test_symmetric_split_policy_via_triu_kernel(monkeypatch):
    monkeypatch.setattr(triu_matmul, "_BLOCK", 64)
    a_sp = sp.random(200, 150, density=0.1, format="csr", random_state=5)
    b_sp = sp.random(150, 200, density=0.1, format="csr", random_state=6)
    ref = np.triu((a_sp @ b_sp).toarray())
    got = np.asarray(
        dense_path.spgemm_dense_out(
            from_scipy(a_sp), from_scipy(b_sp), symmetric=True, precision="split"
        )
    )
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-8)


def test_triple_product_via_triu_kernel(monkeypatch):
    """triple_product_dense's second contraction runs the triangular product."""
    monkeypatch.setattr(triu_matmul, "_BLOCK", 64)
    calls = []
    real = triple_product.matmul_triu

    def spy(*args, **kw):
        calls.append(kw.get("transpose_b"))
        return real(*args, **kw)

    monkeypatch.setattr(triple_product, "matmul_triu", spy)
    h_sp = sp.random(200, 300, density=0.1, format="csr", random_state=3)
    q_sp = sp.random(300, 300, density=0.1, format="csr", random_state=4)
    full = (h_sp @ q_sp @ h_sp.T).toarray()
    h = from_scipy(h_sp, dtype=jnp.float32)
    q = from_scipy(q_sp, dtype=jnp.float32)
    upper = np.asarray(triple_product.triple_product_dense(h, q, 0, precision="fast"))
    mirrored = np.asarray(triple_product.triple_product_dense(h, q, 1, precision="fast"))
    assert calls == [True, True]
    np.testing.assert_allclose(upper, np.triu(full), rtol=1e-4, atol=1e-5)
    sym = np.triu(full) + np.triu(full, 1).T
    np.testing.assert_allclose(mirrored, sym, rtol=1e-4, atol=1e-5)
