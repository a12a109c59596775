"""Fused triple product C = H . Q . H^T (dense symmetric output).

Mirrors the reference's ``triple_product``
(``/root/reference/src/sparse_sparse_dense.cpp:141-249``): the intermediate
``T = H.Q`` is never materialized as a *sparse* matrix, and with
``compute_full_matrix=1`` the lower triangle is a mirror of the upper one
(``:213-215``) -- i.e. the output is symmetrized even if ``Q`` is not
symmetric.  We reproduce that contract exactly.

The two contractions are chained dense products under the precision
policy; the second one, ``T . H^T``, runs the upper-triangular product
(:func:`.triu_matmul.matmul_triu`), mirroring the reference's k-from-i
loop (``sparse_sparse_dense.cpp:200-216``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import CSRMatrix
from .convert import csr_to_dense
from .matmul import policy_dtype, policy_matmul
from .triu_matmul import matmul_triu

__all__ = ["triple_product_dense"]


def _triu_transposed(t, hd):
    return matmul_triu(t, hd, transpose_b=True)


def triple_product_dense(
    h: CSRMatrix,
    q: CSRMatrix,
    compute_full_matrix: int = 0,
    precision: str | None = None,
) -> jax.Array:
    """Dense (m x m) result of H(m x n) . Q(n x n) . H^T.

    ``compute_full_matrix=0`` -> upper triangle only (lower is zero);
    ``compute_full_matrix=1`` -> upper triangle mirrored into the lower.
    """
    dtype = policy_dtype(precision)
    out_dtype = jnp.result_type(h.dtype, q.dtype)
    hd = csr_to_dense(h, dtype)
    qd = csr_to_dense(q, dtype)
    t = policy_matmul(hd, qd, precision, out_dtype=out_dtype)
    upper = policy_matmul(t, hd, precision, out_dtype=out_dtype, matmul=_triu_transposed)
    if compute_full_matrix:
        return upper + jnp.triu(upper, 1).T
    return upper
