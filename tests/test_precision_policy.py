"""Precision policy: resolution is backend-free, and each policy computes
what its docstring says."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import sparse_matrix_mult_tpu as smm
from sparse_matrix_mult_tpu import api
from sparse_matrix_mult_tpu.config import Precision
from sparse_matrix_mult_tpu.ops.matmul import (
    policy_dtype,
    policy_matmul,
    resolve_precision,
    split_operand,
)


@pytest.fixture
def config_precision():
    old = smm.get_config()

    def set_(p):
        smm.set_config(precision=p)

    yield set_
    smm.set_config(old)


@pytest.mark.parametrize(
    "request_,expected",
    [
        (Precision.AUTO, Precision.STRICT),
        (Precision.STRICT, Precision.STRICT),
        (Precision.FAST, Precision.FAST),
        (Precision.SPLIT, Precision.SPLIT),
        (None, Precision.STRICT),
    ],
)
def test_resolve_precision(request_, expected):
    assert resolve_precision(request_) == expected


def test_resolve_precision_reads_config(config_precision):
    config_precision(Precision.FAST)
    assert resolve_precision(None) == Precision.FAST
    assert resolve_precision(Precision.AUTO) == Precision.STRICT


def test_resolve_precision_rejects_unknown():
    with pytest.raises(ValueError):
        resolve_precision("bf16")


@pytest.mark.parametrize(
    "policy,dtype", [(Precision.AUTO, None), (Precision.FAST, jnp.float32), (Precision.SPLIT, None)]
)
def test_policy_dtype(policy, dtype):
    assert policy_dtype(policy) == dtype


@pytest.mark.parametrize(
    "policy,dtype", [(Precision.AUTO, jnp.float64), (Precision.FAST, jnp.float32)]
)
def test_upload_dtype_follows_config(config_precision, monkeypatch, policy, dtype):
    """The scipy entry point uploads in the configured policy's dtype and
    returns float64 either way."""
    config_precision(policy)
    smm.set_config(auto_calibrate_link=False, host_compute_limit=0, host_rate_base=1e3)
    seen = []
    real = api.from_scipy

    def spy(mat, dtype=None, **kw):
        out = real(mat, dtype=dtype, **kw)
        seen.append(out.dtype)
        return out

    monkeypatch.setattr(api, "from_scipy", spy)
    a = sp.random(120, 90, density=0.2, format="csr", random_state=1)
    b = sp.random(90, 120, density=0.2, format="csr", random_state=2)
    got = smm.sparse_matrix_multiply(a, b, output_format="dense")
    assert smm.get_last_route() == "dense"
    assert seen and all(d == dtype for d in seen)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, (a @ b).toarray(), rtol=1e-5, atol=1e-8)


def test_split_operand_is_exact_to_double_f32():
    x = jnp.asarray(np.random.default_rng(0).standard_normal(1000))
    hi, lo = split_operand(x)
    assert hi.dtype == lo.dtype == jnp.float32
    err = np.abs(np.asarray(hi, np.float64) + np.asarray(lo, np.float64) - np.asarray(x))
    assert err.max() <= 1e-14 * np.abs(np.asarray(x)).max()


@pytest.mark.parametrize(
    "policy,rtol", [(Precision.AUTO, 1e-13), (Precision.FAST, 1e-5), (Precision.SPLIT, 1e-6)]
)
def test_policy_matmul_accuracy(policy, rtol):
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(60, 80))
    b = rng.uniform(size=(80, 50))
    got = policy_matmul(jnp.asarray(a), jnp.asarray(b), policy)
    assert got.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(got), a @ b, rtol=rtol)
