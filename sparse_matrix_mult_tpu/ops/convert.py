"""Device-side CSR <-> dense conversion via monotonic shift networks.

* ``csr_to_dense`` -- a distribute network (~log2 passes of roll+select)
  in place of ``jnp.zeros(...).at[r, c].add(v)``.
* ``dense_to_csr`` -- per-row counts plus a packing network in place of
  ``jnp.nonzero(..., size=cap)``.

Below ``_SMALL`` elements both use the one-op XLA scatter / nonzero form,
which compiles much quicker than a log2(L)-pass network.  On the H100 the
networks measured 2-12x slower than the one-op forms at 10k^2 d=0.1
(``PERF.md``); choosing between them is an open item.

Reference parity: these are the device equivalents of the marshalling
layer (``/root/reference/sparse_matrix_mult/matrix_ops.py:187-240``) plus the
per-thread packed-output construction in the Gustavson workers
(``/root/reference/src/sparsework.cpp:81-148``) -- executed on device, so
results stay in device memory for the next kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import CSRMatrix, INDEX_DTYPE
from .shift_network import (
    compact_1d,
    concentrate,
    distribute,
    monotonic_move_1d,
)

__all__ = ["csr_to_dense", "dense_to_csr", "dense_to_csr_triu", "csr_row_ids"]

# Below this many dense elements the one-op XLA scatter/nonzero lowering
# is used instead of the log2(L)-pass networks.
_SMALL = 1 << 18


def csr_row_ids(a: CSRMatrix) -> jax.Array:
    """Row id of every packed entry, via a distribute + cummax (no gather).

    Equivalent to the marker-scatter + cumsum of :meth:`CSRMatrix.row_ids`.
    """
    rows = a.rows
    counts = a.indptr[1:] - a.indptr[:-1]
    nonempty = counts > 0
    row_iota = jnp.arange(rows, dtype=INDEX_DTYPE)
    # Pack the non-empty row ids, and their segment starts, to a prefix.
    packed_rid, packed_start = compact_1d(
        (row_iota, a.indptr[:-1].astype(INDEX_DTYPE)), nonempty, rows
    )
    k = jnp.sum(nonempty.astype(INDEX_DTYPE))
    # Place each non-empty row's id at its segment start (strictly
    # increasing dests), then forward-fill with a running max.
    (placed,) = distribute((packed_rid,), k, packed_start, a.capacity, axis=0)
    return jax.lax.cummax(placed)


def csr_to_dense(a: CSRMatrix, dtype=None, ncols_pad: int | None = None) -> jax.Array:
    """Dense (rows, cols) array from padded CSR, scatter-free.

    Entries must be sorted by (row, col) with no duplicates -- true for
    every CSRMatrix this framework produces (scipy ``sum_duplicates`` on
    ingest, monotone construction internally).
    """
    rows, cols = a.shape
    dtype = dtype or a.values.dtype
    ncols_pad = ncols_pad or cols

    if rows * cols <= _SMALL:
        return a.todense(dtype)

    rid = csr_row_ids(a)
    dest = rid * ncols_pad + a.indices  # strictly increasing over live slots
    nnz = a.nnz
    vals = a.values.astype(dtype)

    (flat,) = distribute((vals,), nnz, dest, rows * ncols_pad, axis=0)
    dense = flat.reshape(rows, ncols_pad)
    return dense[:, :cols] if ncols_pad != cols else dense


def dense_to_csr_triu(c: jax.Array, capacity: int, dtype=None) -> CSRMatrix:
    """Packed CSR of a square upper-triangular dense matrix (the symmetric
    routines' outputs).  The lower half is zero, so the plain extractor
    applies as is."""
    if dtype is not None:
        c = c.astype(dtype)
    return dense_to_csr(c, capacity)


def dense_to_csr(
    c: jax.Array,
    capacity: int,
    keep=None,
    dtype=None,
) -> CSRMatrix:
    """Padded CSR from a dense array, scatter-free (jit-composable).

    ``keep`` optionally overrides the nonzero mask (e.g. ``jnp.triu`` masks
    for symmetric outputs that must keep structural zeros).
    Entries beyond ``capacity`` are dropped (callers size capacity from the
    operand structure, as the host API does).
    """
    rows, cols = c.shape
    if keep is None:
        if dtype is not None:
            c = c.astype(dtype)
            dtype = None
        if rows * cols <= _SMALL:
            # Small path: nonzero-with-static-size compiles much faster and
            # is equivalent when the mask is plain nonzero.
            from ..types import from_dense

            return from_dense(c, capacity)
        keep = c != 0
    counts = jnp.sum(keep, axis=1, dtype=INDEX_DTYPE)
    indptr = jnp.concatenate(
        [jnp.zeros(1, INDEX_DTYPE), jnp.cumsum(counts, dtype=INDEX_DTYPE)]
    )

    col_iota = jax.lax.broadcasted_iota(INDEX_DTYPE, (rows, cols), 1)
    vals = c if dtype is None else c.astype(dtype)

    # Global packing: flatten and compact.  Destinations indptr[r] + slot are
    # strictly increasing across the flattened array, so a single 1D
    # concentrate produces exactly the packed CSR layout.
    flat_keep = keep.reshape(-1)
    flat_vals = vals.reshape(-1)
    flat_cols = col_iota.reshape(-1)
    values, indices = compact_1d((flat_vals, flat_cols), flat_keep, capacity)
    return CSRMatrix(
        indptr=indptr,
        indices=indices.astype(INDEX_DTYPE),
        values=values,
        shape=(rows, cols),
    )
