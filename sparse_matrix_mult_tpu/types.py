"""Device-resident sparse containers for the SpGEMM framework.

Design notes
------------
The reference framework (vineety/sparse_matrix_mult) represents CSR matrices as
malloc'd C structs with grow-on-demand reallocation
(``/root/reference/include/matrix_def.h:17-24``,
``/root/reference/src/memfunctions.cpp:77-103``).  XLA requires static shapes,
so the device container is a **capacity-padded CSR pytree**:

* ``indptr``  -- int32, shape ``(rows + 1,)``, exact cumulative row pointers.
* ``indices`` -- int32, shape ``(capacity,)``; entries past ``indptr[-1]`` are
  padding and hold ``0``.
* ``values``  -- float, shape ``(capacity,)``; padding entries hold ``0.0``.

``capacity`` is a *static* Python int (part of the pytree structure), while the
logical ``nnz`` lives at ``indptr[-1]`` on device so the container stays fully
``jit``-composable.  All kernels in this package treat tail padding as
zero-valued entries at row 0 / column 0, which is harmless under the
scatter-*add* semantics every consumer uses.

Capacities are bucketed (powers of two by default, see
:func:`bucket_capacity`) so repeated calls with similar problem sizes reuse
compiled executables instead of triggering recompilation -- the device analogue of
the reference's geometric realloc policy (``sparsework.cpp:81-103``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "row_ids_from_indptr",
    "CSRMatrix",
    "bucket_capacity",
    "from_scipy",
    "to_scipy",
    "from_dense",
]

Shape = Tuple[int, int]

INDEX_DTYPE = jnp.int32


def row_ids_from_indptr(indptr: jax.Array, capacity: int) -> jax.Array:
    """Row id of every entry position ``0..capacity`` from CSR row pointers.

    Marker scatter + inclusive cumsum, NOT ``jnp.searchsorted``: the
    searchsorted 'scan' lowering is a while loop of log2(rows) dependent
    steps, each a separate scheduling step.  ``marker[p]`` counts the
    rows starting at entry
    position ``p`` (empty rows stack markers; ``side='right'`` semantics:
    an entry at a row start belongs to that row).  Positions past
    ``indptr[-1]`` return the last row's id -- mask at the call site if
    padding must map elsewhere.  Shared by CSRMatrix.row_ids and the
    distributed ring kernels.
    """
    marker = (
        jnp.zeros(capacity + 1, INDEX_DTYPE).at[indptr[1:]].add(1, mode="drop")
    )
    return jnp.cumsum(marker[:capacity], dtype=INDEX_DTYPE)


def bucket_capacity(n: int, minimum: int = 128) -> int:
    """Round ``n`` up to a capacity bucket (next power of two).

    Bucketing keeps the number of distinct compiled shapes logarithmic in the
    problem-size range, mirroring the intent of the reference's ``imem_size``
    heuristic + geometric realloc (``sparse_sparse_sparse.cpp:69-80``,
    ``sparsework.cpp:81-103``) without any dynamic allocation.
    """
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Capacity-padded CSR matrix as a JAX pytree.

    Device counterpart of the reference's ``struct sparsemat``
    (``/root/reference/include/matrix_def.h:17-24``): same logical fields
    (rowPtr/colInd/values + dims), but with static capacity instead of
    ``nzmax`` + realloc, and device-resident arrays instead of host pointers.
    """

    indptr: jax.Array  # (rows + 1,) int32
    indices: jax.Array  # (capacity,) int32
    values: jax.Array  # (capacity,) float
    shape: Shape  # static

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        return (self.indptr, self.indices, self.values), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        indptr, indices, values = children
        (shape,) = aux
        return cls(indptr=indptr, indices=indices, values=values, shape=shape)

    # -- static properties ------------------------------------------------
    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self) -> jax.Array:
        """Logical number of stored entries (device scalar, traced under jit)."""
        return self.indptr[-1]

    # -- conversions -------------------------------------------------------
    def row_ids(self) -> jax.Array:
        """Row index of every stored entry, padding mapped to row 0.

        See :func:`row_ids_from_indptr` -- the device-side replacement for
        iterating ``rowPtr`` the way the reference's Gustavson loop does
        (``sparsework.cpp:56-60``).  Padding (positions >= nnz) remaps to
        row 0 (values are zero anyway so downstream scatter-adds are
        no-ops).
        """
        cap = self.capacity
        positions = jnp.arange(cap, dtype=INDEX_DTYPE)
        rid = row_ids_from_indptr(self.indptr, cap)
        return jnp.where(positions < self.nnz, rid, 0)

    def todense(self, dtype=None) -> jax.Array:
        """Scatter-add to a dense ``(rows, cols)`` array (jit-composable).

        ``dtype`` lets callers densify directly into the compute dtype (e.g.
        f32 under the FAST policy) so no wide-precision arithmetic happens
        on the hot path.
        """
        dtype = dtype or self.values.dtype
        out = jnp.zeros(self.shape, dtype=dtype)
        mask = jnp.arange(self.capacity) < self.nnz
        vals = jnp.where(mask, self.values, 0).astype(dtype)
        return out.at[self.row_ids(), self.indices].add(vals)

    def transpose_dense(self) -> jax.Array:
        """Dense transpose (used by the dense triple-product path)."""
        return self.todense().T

    def with_capacity(self, capacity: int) -> "CSRMatrix":
        """Return a copy with a different (static) entry capacity.

        Growth zero-pads, shrink truncates (caller must ensure
        ``capacity >= nnz``).  Device analogue of the reference's
        ``modifyalloc`` realloc (``/root/reference/src/memfunctions.cpp:77-103``);
        jit-composable since ``capacity`` is static.
        """
        cap = int(capacity)
        if cap == self.capacity:
            return self
        if cap > self.capacity:
            indices = jnp.pad(self.indices, (0, cap - self.capacity))
            values = jnp.pad(self.values, (0, cap - self.capacity))
        else:
            indices = self.indices[:cap]
            values = self.values[:cap]
        return CSRMatrix(self.indptr, indices, values, self.shape)

    def block_until_ready(self) -> "CSRMatrix":
        jax.block_until_ready((self.indptr, self.indices, self.values))
        return self


# ---------------------------------------------------------------------------
# Host-side converters (scipy <-> device).  Parity with the reference's
# marshalling layer csr_to_sparsemat / sparsemat_to_csr
# (/root/reference/sparse_matrix_mult/matrix_ops.py:187-228), minus the ctypes
# copies: data is uploaded once to device memory.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cap",))
def _pad_entries(indices: jax.Array, values: jax.Array, cap: int):
    """Zero-pad fine-bucket uploads up to the canonical power-of-two
    capacity on device (one cheap dispatch; keeps every downstream kernel
    compiled against stable power-of-two shapes)."""
    pad = cap - indices.shape[0]
    return jnp.pad(indices, (0, pad)), jnp.pad(values, (0, pad))


def from_scipy(mat, dtype=None, capacity: int | None = None) -> CSRMatrix:
    """Upload a scipy CSR (or anything csr_matrix accepts) to device.

    The container capacity is a power of two (compile stability), but the
    host->device transfer only carries a fine-bucketed payload (<= 6.25%
    padding) when the saving is material; the remaining zero-padding is
    materialized on device.
    """
    import scipy.sparse as _sp

    from .utils.transfer import fine_capacity

    if not _sp.issparse(mat):
        mat = _sp.csr_matrix(np.asarray(mat))
    mat = mat.tocsr()
    mat.sum_duplicates()
    nnz = int(mat.nnz)
    cap = capacity if capacity is not None else bucket_capacity(nnz)
    if cap < nnz:
        raise ValueError(f"capacity {cap} < nnz {nnz}")
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    indptr = jnp.asarray(mat.indptr, dtype=INDEX_DTYPE)
    fine = min(fine_capacity(nnz), cap)
    entry_bytes = 4 + np.dtype(dtype).itemsize
    if fine < cap and (cap - fine) * entry_bytes > (4 << 20):
        up_cap = fine
    else:
        up_cap = cap
    indices = np.zeros(up_cap, dtype=np.int32)
    values = np.zeros(up_cap, dtype=np.dtype(dtype))
    indices[:nnz] = mat.indices
    values[:nnz] = mat.data
    idx_d = jnp.asarray(indices)
    val_d = jnp.asarray(values)
    if up_cap < cap:
        idx_d, val_d = _pad_entries(idx_d, val_d, cap)
    return CSRMatrix(
        indptr=indptr,
        indices=idx_d,
        values=val_d,
        shape=tuple(int(s) for s in mat.shape),
    )


@functools.partial(jax.jit, static_argnames=("fine",))
def _trim_to(indices: jax.Array, values: jax.Array, fine: int):
    """Slice both entry arrays to a fine transfer capacity (one dispatch).

    Static ``fine`` comes from :func:`utils.transfer.fine_capacity`: at most
    16 distinct slice programs per octave, each a trivial compile.
    """
    return indices[:fine], values[:fine]


def to_scipy(mat: CSRMatrix):
    """Download a device CSRMatrix to an exact (trimmed) scipy csr_matrix.

    Transfer policy (the device->host link can be much of the cost of a
    scipy-out call):

    * Capacities are powers of two (compile stability), i.e. up to 2x the
      payload.  When the saving is material the entry arrays are first
      sliced on device to a fine bucket (<= 6.25% slack; one cheap extra
      dispatch) -- slicing to the *exact* data-dependent nnz would compile a
      fresh program per distinct nnz.
    * Large buffers download as concurrent row-block chunks
      (:func:`utils.transfer.fetch_np`).
    """
    import scipy.sparse as _sp

    from .utils.transfer import fetch_np, fine_capacity

    indptr = np.asarray(mat.indptr)
    nnz = int(indptr[-1])
    cap = mat.capacity
    fine = min(fine_capacity(nnz), cap)
    entry_bytes = mat.indices.dtype.itemsize + mat.values.dtype.itemsize
    idx_d, val_d = mat.indices, mat.values
    if fine < cap and (cap - fine) * entry_bytes > (4 << 20):
        idx_d, val_d = _trim_to(mat.indices, mat.values, fine)
    indices = fetch_np(idx_d)[:nnz]
    values = fetch_np(val_d)[:nnz]
    out = _sp.csr_matrix((values, indices, indptr), shape=mat.shape)
    return out


def from_dense(dense: jax.Array, capacity: int) -> CSRMatrix:
    """Extract the nonzero structure of a dense array into padded CSR.

    Fully jit-composable: ``capacity`` is static; uses masked ``nonzero`` with
    a static ``size``.  This is the device-side replacement for the
    reference's dense->CSR conversions done implicitly on the host.
    """
    rows, cols = dense.shape
    mask = dense != 0
    counts = jnp.sum(mask, axis=1, dtype=INDEX_DTYPE)
    indptr = jnp.concatenate(
        [jnp.zeros(1, INDEX_DTYPE), jnp.cumsum(counts, dtype=INDEX_DTYPE)]
    )
    flat = mask.reshape(-1)
    (pos,) = jnp.nonzero(flat, size=capacity, fill_value=rows * cols)
    valid = pos < rows * cols
    safe = jnp.where(valid, pos, 0)
    cols_idx = (safe % cols).astype(INDEX_DTYPE)
    vals = dense.reshape(-1)[safe]
    indices = jnp.where(valid, cols_idx, 0)
    values = jnp.where(valid, vals, 0)
    return CSRMatrix(indptr=indptr, indices=indices, values=values, shape=(rows, cols))
