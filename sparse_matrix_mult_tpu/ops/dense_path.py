"""Dense fast path: densify -> dense matmul -> (optionally) re-sparsify.

Rationale: at the densities the reference targets and benchmarks (0.01-0.3,
``/root/reference/tests/test_with_dense.py:30``, ``README.md:216-220``) the
product matrix is nearly dense, and a dense GEMM performs the product far
faster than any scatter-based sparse inner loop.  So for any problem whose
dense forms fit comfortably in device memory we lower SpGEMM onto one dense
product: scatter the CSR operands into dense arrays (pure memory ops), run
one policy matmul, and extract the result structure with a two-phase
count/cumsum/fill -- the static-shape replacement of the reference's
count->allocate->stitch pipeline (``sparse_sparse_sparse.cpp:129-150``).

For problems past :attr:`Config.dense_path_limit` use
:mod:`sparse_matrix_mult_tpu.ops.spgemm_jnp` (expansion sort).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import get_config
from ..types import CSRMatrix
from .convert import csr_to_dense, dense_to_csr
from .matmul import policy_dtype, policy_matmul
from .triu_matmul import matmul_triu

__all__ = [
    "spgemm_dense_out",
    "spgemm_sparse_out",
    "dense_path_fits",
    "product_dense",
]


def dense_path_fits(*shapes) -> bool:
    limit = get_config().dense_path_limit
    return all(int(s[0]) * int(s[1]) <= limit for s in shapes)


def product_dense(
    a: CSRMatrix, b: CSRMatrix, precision: str | None = None, matmul=None
) -> jax.Array:
    """Dense A@B under a precision policy, densifying directly in the
    policy's compute dtype."""
    dtype = policy_dtype(precision)
    ad = csr_to_dense(a, dtype)
    bd = csr_to_dense(b, dtype)
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    return policy_matmul(ad, bd, precision, out_dtype=out_dtype, matmul=matmul)


def spgemm_dense_out(
    a: CSRMatrix,
    b: CSRMatrix,
    symmetric: bool = False,
    precision: str | None = None,
) -> jax.Array:
    """sparse x sparse -> dense, mirroring ``dense_nosym``/``dense_sym``
    (``/root/reference/src/sparse_sparse_dense.cpp:79-131``, ``:13-74``).

    ``symmetric=True`` returns the upper triangle with zero lower triangle,
    matching the reference's contract.  A square symmetric product runs
    the upper-triangular product (:func:`.triu_matmul.matmul_triu`), which
    skips the strictly-lower blocks.
    """
    if symmetric:
        if a.shape[0] == b.shape[1]:
            return product_dense(a, b, precision, matmul=matmul_triu)
        return jnp.triu(product_dense(a, b, precision))
    return product_dense(a, b, precision)


def spgemm_sparse_out(
    a: CSRMatrix,
    b: CSRMatrix,
    out_capacity: int,
    symmetric: bool = False,
    precision: str | None = None,
) -> CSRMatrix:
    """sparse x sparse -> padded CSR via the dense fast path (jit-composable).

    Note on structure: entries whose computed value is exactly 0 are dropped,
    whereas Gustavson implementations (the reference's and scipy's) keep such
    structural zeros.  All differential tests compare dense forms, where this
    is invisible.
    """
    c = spgemm_dense_out(a, b, symmetric=symmetric, precision=precision)
    return dense_to_csr(c, out_capacity)
