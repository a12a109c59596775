"""Chunked, concurrent device->host transfers.

The scipy-in/scipy-out API moves every result across the host<->device
link.  Two mechanisms, both transparent to callers:

* **Chunked concurrent fetch** (:func:`fetch_np`): one jitted program
  splits the array into row blocks (one dispatch, N output buffers), and a
  small thread pool streams the blocks down concurrently.
* **Panel download + host pack** (:func:`fetch_dense_to_csr`): for
  dense-ish products the API downloads the raw panel instead of packed
  CSR (fewer bytes past ~50% density) and packs it into CSR on host with
  the native OpenMP kernel
  (:func:`~sparse_matrix_mult_tpu.utils.native.dense_pack`).

Reference analogue: the ctypes marshalling layer
(``/root/reference/sparse_matrix_mult/matrix_ops.py:205-240``) copies
results out of C structs; here the "copy out" crosses the device link.
Whether chunking helps on a PCIe-attached H100 is not measured.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fetch_np", "fetch_dense_to_csr", "fine_capacity"]

# Fetch chunking: engage above this many bytes, in pieces of _PIECE_BYTES
# over _WORKERS streams.  Not measured on the H100.
_CHUNK_THRESHOLD = 16 << 20
_PIECE_BYTES = 8 << 20
_MAX_PIECES = 64
_WORKERS = 6


def fine_capacity(n: int, minimum: int = 128) -> int:
    """Round ``n`` up to a fine capacity bucket (<= 1/16 slack).

    The canonical container capacity is a power of two (stable compiled
    shapes, :func:`sparse_matrix_mult_tpu.types.bucket_capacity`) but
    transfers should not move up to 2x the payload.
    Fine buckets are multiples of 2^(k-5) within each octave: at most 32
    distinct transfer shapes per octave, padding bounded by 1/16.
    """
    n = max(int(n), minimum)
    step = max(1 << max(n.bit_length() - 5, 0), minimum)
    return -(-n // step) * step


@functools.partial(jax.jit, static_argnames=("nblocks",))
def _split_rows(x: jax.Array, nblocks: int):
    """Split along axis 0 into ``nblocks`` near-equal blocks -- ONE device
    dispatch producing ``nblocks`` output buffers (each slice is static)."""
    m = x.shape[0]
    base = m // nblocks
    extra = m % nblocks
    out = []
    start = 0
    for i in range(nblocks):
        stop = start + base + (1 if i < extra else 0)
        out.append(x[start:stop])
        start = stop
    return tuple(out)


def _nblocks_for(nbytes: int) -> int:
    return max(1, min(_MAX_PIECES, -(-nbytes // _PIECE_BYTES)))


def fetch_np(x: jax.Array) -> np.ndarray:
    """Device array -> numpy, chunked+concurrent past 16 MB."""
    nbytes = x.size * x.dtype.itemsize
    if nbytes < _CHUNK_THRESHOLD or x.ndim == 0 or x.shape[0] < 2:
        return np.asarray(x)
    nblocks = _nblocks_for(nbytes)
    pieces = _split_rows(x, nblocks)
    out = np.empty(x.shape, x.dtype)
    offsets = np.cumsum([0] + [p.shape[0] for p in pieces])

    def _fetch(i):
        np.copyto(out[offsets[i] : offsets[i + 1]], np.asarray(pieces[i]))

    with ThreadPoolExecutor(min(_WORKERS, nblocks)) as ex:
        list(ex.map(_fetch, range(nblocks)))
    return out


def _pack_full_dense(panel: np.ndarray):
    """CSR of a panel with NO zero entries: structure is trivial, so skip
    the nonzero scan entirely (pure vectorized writes, ~1 s at 1e8)."""
    import scipy.sparse as sp

    m, n = panel.shape
    indptr = (np.arange(m + 1, dtype=np.int64) * n)
    indices = np.tile(np.arange(n, dtype=np.int32), m)
    values = panel.reshape(-1).astype(np.float64)
    if indptr[-1] <= np.iinfo(np.int32).max:
        indptr = indptr.astype(np.int32)
    return sp.csr_matrix((values, indices, indptr), shape=(m, n))


def fetch_dense_to_csr(c: jax.Array, symmetric: bool = False, nnz: int | None = None):
    """Download a dense (m, n) device panel and pack it to scipy CSR (f64).

    Fetch and pack run sequentially, so the OpenMP pack has the host's
    cores to itself.  When the caller knows the
    panel is 100% dense (``nnz == m*n``), the nonzero scan is skipped and
    CSR structure is written directly.  ``symmetric`` panels have a zero
    lower triangle, which simply never packs.
    """
    from .native import dense_pack

    m, n = c.shape
    panel = fetch_np(c)
    if nnz is not None and not symmetric and nnz == m * n:
        return _pack_full_dense(panel)
    return dense_pack(panel)
