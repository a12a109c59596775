"""ctypes loader for the native host runtime (native/libsmmhost.so).

Mirrors the reference's singleton library loader
(``/root/reference/sparse_matrix_mult/matrix_ops.py:51-184``) but degrades
gracefully: every entry point has a pure-numpy fallback, so the package works
without the compiled library (the device compute path never depends on it; the
native layer only accelerates host-side structure analysis and stitching).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

__all__ = [
    "get_native",
    "expansion_size",
    "row_flops",
    "stitch_csr",
    "csr_triu",
    "spgemm_host",
    "dense_pack",
]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)


def _lib_candidates():
    """Candidate library paths, most specific first.

    1. Package data (``sparse_matrix_mult_tpu/lib/``) -- where the wheel
       build (``setup.py``) puts the compiled library; platform/arch-named
       like the reference's shipped binaries
       (``/root/reference/sparse_matrix_mult/matrix_ops.py:93-130``).
    2. Any ``libsmmhost*`` in the package lib dir (cross-built names).
    3. Dev checkout: ``<repo>/native/libsmmhost.so`` (Makefile output).
    """
    import glob
    import platform

    ext = {"Darwin": "dylib", "Windows": "dll"}.get(platform.system(), "so")
    machine = platform.machine().lower()
    arch = "arm64" if machine in ("arm64", "aarch64") else "x86_64"
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg_lib = os.path.join(pkg_dir, "lib")
    yield os.path.join(pkg_lib, f"libsmmhost_{arch}.{ext}")
    yield from sorted(glob.glob(os.path.join(pkg_lib, f"libsmmhost*.{ext}")))
    repo_native = os.path.join(os.path.dirname(pkg_dir), "native")
    yield os.path.join(repo_native, "libsmmhost.so")


def _build_dev() -> Optional[str]:
    """Dev-checkout convenience: build via the Makefile if sources are here."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    native_dir = os.path.join(os.path.dirname(pkg_dir), "native")
    if not os.path.exists(os.path.join(native_dir, "Makefile")):
        return None
    path = os.path.join(native_dir, "libsmmhost.so")
    try:
        subprocess.run(
            ["make", "-C", native_dir],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return path if os.path.exists(path) else None
    except Exception:
        return None


def get_native() -> Optional[ctypes.CDLL]:
    """Load (building on first use if needed) the host library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = next((p for p in _lib_candidates() if os.path.exists(p)), None)
    if path is None:
        path = _build_dev()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.smm_expansion_size.restype = ctypes.c_int64
    lib.smm_expansion_size.argtypes = [_I32, ctypes.c_int64, _I32]
    lib.smm_row_flops.restype = None
    lib.smm_row_flops.argtypes = [_I32, _I32, ctypes.c_int64, _I32, _F64]
    lib.smm_flop_balanced_partition.restype = None
    lib.smm_flop_balanced_partition.argtypes = [
        _F64, ctypes.c_int64, ctypes.c_int64, _I64,
    ]
    lib.smm_stitch_csr.restype = None
    lib.smm_stitch_csr.argtypes = [
        ctypes.c_int64, _I64, _I32, _I64, _I32, _F64, _I64, _I32, _I32, _F64,
    ]
    lib.smm_csr_triu.restype = ctypes.c_int64
    lib.smm_csr_triu.argtypes = [
        ctypes.c_int64, _I32, _I32, _F64, _I32, _I32, _F64,
    ]
    lib.smm_num_threads.restype = ctypes.c_int32
    lib.smm_num_threads.argtypes = []
    _F32 = ctypes.POINTER(ctypes.c_float)
    lib.smm_dense_pack_count_f32.restype = None
    lib.smm_dense_pack_count_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _F32, _I32,
    ]
    lib.smm_dense_pack_fill_f32.restype = None
    lib.smm_dense_pack_fill_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _F32, _I32, _I32, _F64,
    ]
    lib.smm_dense_pack_count_f64.restype = None
    lib.smm_dense_pack_count_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _F64, _I32,
    ]
    lib.smm_dense_pack_fill_f64.restype = None
    lib.smm_dense_pack_fill_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _F64, _I32, _I32, _F64,
    ]
    lib.smm_spgemm_count.restype = None
    lib.smm_spgemm_count.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I32, _I32, _I32, _I32,
        ctypes.c_int32, ctypes.c_int32, _I32,
    ]
    lib.smm_spgemm_fill.restype = None
    lib.smm_spgemm_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I32, _I32, _F64, _I32, _I32,
        _F64, ctypes.c_int32, ctypes.c_int32, _I32, _I32, _F64,
    ]
    _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def expansion_size(a_indices, a_nnz: int, b_indptr) -> int:
    """Total partial products of A @ B (= ESC expand capacity, flop count)."""
    a_indices = np.ascontiguousarray(np.asarray(a_indices)[:a_nnz], np.int32)
    b_indptr = np.ascontiguousarray(b_indptr, np.int32)
    lib = get_native()
    if lib is not None and a_nnz > 0:
        return int(
            lib.smm_expansion_size(_ptr(a_indices, _I32), a_nnz, _ptr(b_indptr, _I32))
        )
    if a_nnz == 0:
        return 0
    return int((b_indptr[a_indices + 1] - b_indptr[a_indices]).sum())


def row_flops(a_indptr, a_indices, b_indptr) -> np.ndarray:
    """Partial products contributed by each row of A."""
    a_indptr = np.ascontiguousarray(a_indptr, np.int32)
    a_indices = np.ascontiguousarray(a_indices, np.int32)
    b_indptr = np.ascontiguousarray(b_indptr, np.int32)
    rows = len(a_indptr) - 1
    lib = get_native()
    if lib is not None:
        out = np.empty(rows, np.float64)
        lib.smm_row_flops(
            _ptr(a_indptr, _I32), _ptr(a_indices, _I32), rows,
            _ptr(b_indptr, _I32), _ptr(out, _F64),
        )
        return out
    nnz = int(a_indptr[-1])
    per_entry = b_indptr[a_indices[:nnz] + 1] - b_indptr[a_indices[:nnz]]
    row_ids = np.repeat(np.arange(rows), np.diff(a_indptr))
    return np.bincount(row_ids, weights=per_entry, minlength=rows)


def stitch_csr(chunks, total_rows: int, ncols: int):
    """Stitch row-chunk scipy CSR pieces into one scipy CSR matrix.

    Host analogue of the reference orchestrators' stitch
    (``/root/reference/src/sparse_sparse_sparse.cpp:269-291``).
    """
    import scipy.sparse as sp

    lib = get_native()
    if lib is None:
        return sp.vstack(chunks, format="csr")

    n = len(chunks)
    chunk_rows = np.array([c.shape[0] for c in chunks], np.int64)
    indptrs = [np.ascontiguousarray(c.indptr, np.int32) for c in chunks]
    indptr_offsets = np.zeros(n, np.int64)
    off = 0
    for i, ip in enumerate(indptrs):
        indptr_offsets[i] = off
        off += len(ip)
    indptr_cat = np.concatenate(indptrs) if indptrs else np.zeros(1, np.int32)
    entry_offsets = np.zeros(n, np.int64)
    off = 0
    for i, c in enumerate(chunks):
        entry_offsets[i] = off
        off += c.nnz
    nnz_total = off
    indices_cat = (
        np.concatenate([np.ascontiguousarray(c.indices, np.int32) for c in chunks])
        if nnz_total
        else np.zeros(0, np.int32)
    )
    values_cat = (
        np.concatenate([np.ascontiguousarray(c.data, np.float64) for c in chunks])
        if nnz_total
        else np.zeros(0, np.float64)
    )
    out_indptr = np.empty(total_rows + 1, np.int32)
    out_indices = np.empty(nnz_total, np.int32)
    out_values = np.empty(nnz_total, np.float64)
    lib.smm_stitch_csr(
        n,
        _ptr(chunk_rows, _I64),
        _ptr(indptr_cat, _I32),
        _ptr(indptr_offsets, _I64),
        _ptr(indices_cat, _I32),
        _ptr(values_cat, _F64),
        _ptr(entry_offsets, _I64),
        _ptr(out_indptr, _I32),
        _ptr(out_indices, _I32),
        _ptr(out_values, _F64),
    )
    return sp.csr_matrix(
        (out_values, out_indices, out_indptr), shape=(total_rows, ncols)
    )


def csr_triu(mat):
    """Upper-triangle filter of a scipy CSR matrix via the native library."""
    import scipy.sparse as sp

    lib = get_native()
    if lib is None:
        return sp.triu(mat, format="csr")
    rows = mat.shape[0]
    indptr = np.ascontiguousarray(mat.indptr, np.int32)
    indices = np.ascontiguousarray(mat.indices, np.int32)
    values = np.ascontiguousarray(mat.data, np.float64)
    out_indptr = np.empty(rows + 1, np.int32)
    out_indices = np.empty(mat.nnz, np.int32)
    out_values = np.empty(mat.nnz, np.float64)
    nnz = lib.smm_csr_triu(
        rows,
        _ptr(indptr, _I32), _ptr(indices, _I32), _ptr(values, _F64),
        _ptr(out_indptr, _I32), _ptr(out_indices, _I32), _ptr(out_values, _F64),
    )
    return sp.csr_matrix(
        (out_values[:nnz], out_indices[:nnz], out_indptr), shape=mat.shape
    )


def dense_pack(dense: np.ndarray):
    """Pack a dense row-major numpy panel into scipy CSR (float64 values).

    The fast path for dense-ish device results: the API downloads the raw
    f32 panel (fewer bytes than packed CSR past ~50% density) and packs it
    here.  Native two-phase OpenMP kernel when available (~15x scipy's
    serial ``csr_matrix(dense)`` at 1e8 nnz on two cores); vectorized numpy
    fallback otherwise.  Host analogue of the device extraction pipeline
    (count -> cumsum -> fill, ops/convert.py).
    """
    import scipy.sparse as sp

    dense = np.ascontiguousarray(dense)
    m, n = dense.shape
    lib = get_native()
    if lib is not None and dense.dtype in (np.float32, np.float64):
        f32 = dense.dtype == np.float32
        counts = np.empty(m, np.int32)
        count_fn = lib.smm_dense_pack_count_f32 if f32 else lib.smm_dense_pack_count_f64
        fill_fn = lib.smm_dense_pack_fill_f32 if f32 else lib.smm_dense_pack_fill_f64
        dptr = _ptr(dense, ctypes.POINTER(ctypes.c_float) if f32 else _F64)
        count_fn(m, n, dptr, _ptr(counts, _I32))
        indptr64 = np.zeros(m + 1, np.int64)
        np.cumsum(counts, out=indptr64[1:], dtype=np.int64)
        if indptr64[-1] <= np.iinfo(np.int32).max:
            indptr = indptr64.astype(np.int32)
            nnz = int(indptr[-1])
            indices = np.empty(nnz, np.int32)
            values = np.empty(nnz, np.float64)
            fill_fn(m, n, dptr, _ptr(indptr, _I32), _ptr(indices, _I32), _ptr(values, _F64))
            return sp.csr_matrix((values, indices, indptr), shape=(m, n))
    # Vectorized numpy fallback (no per-element Python, ~3x scipy's pack).
    flat = dense.reshape(-1)
    pos = np.flatnonzero(flat)
    indices = (pos % n).astype(np.int32)
    counts = np.bincount((pos // n).astype(np.int64), minlength=m)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    values = flat[pos].astype(np.float64)
    return sp.csr_matrix((values, indices, indptr), shape=(m, n))


def spgemm_host(
    a_sp,
    b_sp,
    symmetric: bool = False,
    n_partials: int | None = None,
    keep_structure: bool = False,
):
    """Host SpGEMM via the native two-phase Gustavson kernel (OpenMP).

    The small-problem escape hatch: below
    :attr:`Config.host_compute_limit` partial products a device dispatch
    costs more wall time than the whole multiply, so the API routes here
    (route name ``"host"``).  Falls back to scipy when the native library
    is unavailable.  Returns scipy CSR with sorted column indices; with
    ``symmetric`` only the upper triangle is computed (the reference's
    ``sparsework_sym`` contract, ``/root/reference/src/sparsework.cpp:217``).

    Structure: the native kernel emits every TOUCHED output slot (Gustavson
    semantics, like the reference's workers) while scipy >= 1.14 prunes
    entries whose accumulated value is exactly 0.  ``keep_structure=True``
    forces the native kernel even below the scipy-crossover size so the
    Gustavson structure contract holds at every size (no native library ->
    scipy result, pruned).
    """
    import scipy.sparse as sp

    if n_partials is None:
        n_partials = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)

    lib = get_native()
    # Engine choice by size (measured on a 2-core x86 host WITH the
    # sorted-indices contract): scipy's serial SMMP + sort_indices wins
    # only below ~2e4 partial products (the sort is 60% of its cost and
    # grows faster than the multiply); the OpenMP two-phase kernel emits
    # sorted rows natively and runs 1.6-3.0x faster everywhere above
    # (e.g. 1000^2 d=0.01: 1.5 ms vs 3.4 ms; 2000^2 d=0.05: 117 ms vs
    # 350 ms).  The route is "best host engine per size", not one kernel.
    if lib is None or (n_partials < (1 << 14) and not keep_structure):
        out = (a_sp @ b_sp).tocsr()
        # scipy's matmul leaves per-row column order unsorted; the native
        # kernel sorts (csr_host.cpp:288).  Canonicalize so the host route
        # honors the documented sorted-indices contract at every size.
        out.sort_indices()
        return csr_triu(out) if symmetric else out

    m, _ = a_sp.shape
    n = b_sp.shape[1]
    a_indptr = np.ascontiguousarray(a_sp.indptr, np.int32)
    a_indices = np.ascontiguousarray(a_sp.indices, np.int32)
    a_values = np.ascontiguousarray(a_sp.data, np.float64)
    b_indptr = np.ascontiguousarray(b_sp.indptr, np.int32)
    b_indices = np.ascontiguousarray(b_sp.indices, np.int32)
    b_values = np.ascontiguousarray(b_sp.data, np.float64)

    parallel = 1  # the scipy branch above owns everything below 16k partials
    counts = np.empty(m, np.int32)
    lib.smm_spgemm_count(
        m, n, _ptr(a_indptr, _I32), _ptr(a_indices, _I32),
        _ptr(b_indptr, _I32), _ptr(b_indices, _I32),
        1 if symmetric else 0, parallel, _ptr(counts, _I32),
    )
    # Prefix-sum in int64: nnz(C) can exceed int32 when the cost model
    # routes a huge product here (slow device link).  The native fill
    # kernel takes int32 indptr, so past the int32 range hand the product
    # to scipy, whose CSR supports int64 indices.
    indptr64 = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=indptr64[1:], dtype=np.int64)
    if indptr64[-1] > np.iinfo(np.int32).max:
        out = (a_sp @ b_sp).tocsr()
        out.sort_indices()
        # csr_triu's native path is int32-only; stay in scipy (int64) here.
        return sp.triu(out, format="csr") if symmetric else out
    out_indptr = indptr64.astype(np.int32)
    nnz = int(out_indptr[-1])
    out_indices = np.empty(nnz, np.int32)
    out_values = np.empty(nnz, np.float64)
    lib.smm_spgemm_fill(
        m, n, _ptr(a_indptr, _I32), _ptr(a_indices, _I32), _ptr(a_values, _F64),
        _ptr(b_indptr, _I32), _ptr(b_indices, _I32), _ptr(b_values, _F64),
        1 if symmetric else 0, parallel, _ptr(out_indptr, _I32),
        _ptr(out_indices, _I32), _ptr(out_values, _F64),
    )
    return sp.csr_matrix((out_values, out_indices, out_indptr), shape=(m, n))
