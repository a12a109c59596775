"""Upper-triangular product: only the ``j >= i`` part of ``a @ b``.

The reference's symmetric routines and its fused triple product emit only
the upper triangle (``/root/reference/src/sparse_sparse_dense.cpp:59-62``,
``:200-216``: the inner loop starts at ``k = i``).  Here the saving is kept
at block granularity by a 2x2 block recursion,

    upper(C) = [[upper(A1 B1), A1 B2], [0, upper(A2 B2)]],

where A1/A2 are the top/bottom row halves of ``a`` and B1/B2 the left/right
column halves of ``b``.  It recurses until a diagonal block is at most
``block`` wide; every block product is one XLA dot.  Depth ``d`` does
``1/2 + 1/2**(d+1)`` of the full product's flops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["matmul_triu"]

_BLOCK = 1024
_ALIGN = 128


def _split(size: int) -> int:
    """Top-half size of a diagonal block: half, rounded up to _ALIGN rows
    when that leaves both halves non-empty."""
    half = -(-(size // 2) // _ALIGN) * _ALIGN
    return half if 0 < half < size else size // 2


def matmul_triu(
    a: jax.Array,
    b: jax.Array,
    transpose_b: bool = False,
    block: int | None = None,
    precision="highest",
) -> jax.Array:
    """Upper triangle (diagonal included) of ``a @ b``, or of ``a @ b.T``
    with ``transpose_b``; zero below the diagonal.

    ``a`` is (M, K); ``b`` is (K, M), or (M, K) with ``transpose_b``.
    ``block`` (default ``_BLOCK``) is the widest diagonal block computed
    whole.  ``precision`` is passed to every block's ``lax.dot_general`` (a
    ``lax.Precision``, its string name, or a ``lax.DotAlgorithmPreset``).
    """
    block = block or _BLOCK
    m = a.shape[0]
    n = b.shape[0] if transpose_b else b.shape[1]
    if m != n:
        raise ValueError(f"matmul_triu needs a square product, got {m} x {n}")
    contract = ((1,), (1,)) if transpose_b else ((1,), (0,))
    out_dtype = jnp.result_type(a.dtype, b.dtype)

    def dot(r0, r1, c0, c1):
        cols = b[c0:c1] if transpose_b else b[:, c0:c1]
        return lax.dot_general(
            a[r0:r1], cols, (contract, ((), ())), precision=precision
        ).astype(out_dtype)

    def blocks(lo, hi):
        if hi - lo <= block:
            yield lo, lo, jnp.triu(dot(lo, hi, lo, hi))
            return
        mid = lo + _split(hi - lo)
        yield from blocks(lo, mid)
        yield lo, mid, dot(lo, mid, mid, hi)
        yield from blocks(mid, hi)

    out = jnp.zeros((m, n), out_dtype)
    for r, c, blk in blocks(0, m):
        out = lax.dynamic_update_slice(out, blk, (r, c))
    return out
