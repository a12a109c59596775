"""Reference-compatible public API.

Drop-in replacement for the reference's single entry point
``sparse_matrix_multiply``
(``/root/reference/sparse_matrix_mult/matrix_ops.py:271-387``): same
signature, same five routines, same scipy-in/scipy-out types, same validation
errors, same empty-operand fast path, same upper-triangle-only contract for
symmetric outputs, and the same "zero matrix" stdout notice.

Differences (deliberate, per design review of the reference):

* Real exceptions propagate -- the reference's catch-all that silently returns
  a zero matrix (``matrix_ops.py:377-387``) is **not** replicated.
* ``imem_size`` is validated identically and HONORED as the working-memory
  hint it is in the reference: there it scales the per-thread intermediate
  pool as a percent-of-dense heuristic
  (``sparse_sparse_sparse.cpp:69-80``, values 1..10 = percent, else 10);
  here the same 1..10 scale multiplies the per-dispatch partial-product
  budget (``Config.esc_expand_limit``) that sizes the flop-balanced row
  chunks, with the default 5 leaving the configured budget unchanged.
* Compute runs on the default JAX backend under the precision policy in
  :mod:`sparse_matrix_mult_tpu.config`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from scipy.sparse import csr_matrix, isspmatrix_csr

from .config import get_config
from .ops.convert import dense_to_csr
from .ops.dense_path import dense_path_fits, spgemm_dense_out
from .ops.matmul import policy_dtype
from .ops.spgemm_jnp import (
    expansion_size,
    spgemm_esc,
    spgemm_esc_windowed,
    windowed_plan,
)
from .ops.triple_product import triple_product_dense
from .types import CSRMatrix, bucket_capacity, from_scipy, to_scipy
from .utils.native import csr_triu, spgemm_host, stitch_csr

__all__ = ["sparse_matrix_multiply", "multiply", "triple_product", "get_last_route"]

# Which compute strategy the last sparse_matrix_multiply dispatch used
# (observability + test assertions): one of "host", "dense", "esc",
# "esc_windowed", "esc_binned", "dense_chunks", "esc_chunks", "triple",
# "empty".
# Thread-local so concurrent callers never read each other's route labels.
import threading as _threading

_ROUTE_STATE = _threading.local()


def get_last_route() -> str | None:
    """Strategy chosen by the most recent :func:`sparse_matrix_multiply`
    on the CALLING thread (thread-local observability)."""
    return getattr(_ROUTE_STATE, "route", None)


def _set_route(route: str, **detail) -> None:
    _ROUTE_STATE.route = route
    _ROUTE_STATE.detail = detail


def get_last_route_detail() -> dict:
    """Diagnostics recorded with the last route (e.g. ``chunks`` for the
    flop-chunked ESC path); empty dict when the route recorded none."""
    return getattr(_ROUTE_STATE, "detail", {}) or {}


def _coerce_csr(m):
    if not isspmatrix_csr(m):
        m = csr_matrix(m)
    return m


@functools.partial(jax.jit, static_argnames=("symmetric",))
def _dense_product(a: CSRMatrix, b: CSRMatrix, symmetric: bool):
    c = spgemm_dense_out(a, b, symmetric=symmetric)
    return c, jnp.sum(c != 0)


@functools.partial(jax.jit, static_argnames=("symmetric",))
def _dense_product_only(a: CSRMatrix, b: CSRMatrix, symmetric: bool):
    return spgemm_dense_out(a, b, symmetric=symmetric)


@functools.partial(jax.jit, static_argnames=("out_capacity", "symmetric"))
def _extract_csr(c, out_capacity: int, symmetric: bool = False):
    if symmetric and c.shape[0] == c.shape[1]:
        from .ops.convert import dense_to_csr_triu

        return dense_to_csr_triu(c, out_capacity)
    return dense_to_csr(c, out_capacity)


def _dense_to_scipy_csr(a_sp, b_sp, symmetric: bool):
    """Single-shot dense path: dense product + extraction.

    Extraction strategy:

    * tiny outputs (< ``host_extract_limit`` elements): download the dense
      panel in one fetch, pack with scipy.
    * dense-ish outputs (panel bytes < packed-CSR bytes, i.e. density
      > ~50% for f32 panels): download the raw panel as concurrent row
      blocks, then pack on host with the native OpenMP kernel
      (utils/transfer.fetch_dense_to_csr).  The 10k x 10k d=0.1 headline
      product is 100% dense -- packed CSR would move 2-3x the bytes.
    * sparse outputs: extract packed CSR on device, download fine-trimmed
      entry arrays chunked (types.to_scipy).
    """
    from .utils.transfer import fetch_dense_to_csr, fine_capacity

    m = a_sp.shape[0]
    n = b_sp.shape[1]
    host_extract = m * n <= get_config().host_extract_limit

    # Operands upload in the policy's compute dtype (f32 under FAST, else
    # f64); results come back as f64 at the host boundary.
    dtype = policy_dtype()
    a = from_scipy(a_sp, dtype=dtype)
    b = from_scipy(b_sp, dtype=dtype)
    if host_extract:
        c = _dense_product_only(a, b, symmetric)
    else:
        c, nnz_dev = _dense_product(a, b, symmetric)
    _set_route("dense")

    if host_extract:
        return csr_matrix(np.asarray(c, dtype=np.float64))

    nnz = int(nnz_dev)  # one scalar fetch; decides the download format

    if symmetric and m == n and nnz == m * (m + 1) // 2:
        # Fully dense upper triangle: the structure is implied, so download
        # ONLY the staircase-packed values (4 B per stored entry -- half the
        # panel, a third of packed CSR) and rebuild indices on host.  Row
        # counts can never exceed n-i on the symmetric path, so total
        # nnz == sum(n-i) forces every row to be exactly full.
        return _fetch_full_triu(c, nnz)

    panel_bytes = m * n * c.dtype.itemsize
    csr_bytes = (4 + c.dtype.itemsize) * fine_capacity(nnz)
    if panel_bytes < csr_bytes:
        return fetch_dense_to_csr(c, symmetric=symmetric, nnz=nnz)

    csr = _extract_csr(c, bucket_capacity(nnz), symmetric=symmetric)
    out = to_scipy(csr)
    if out.dtype != np.float64:
        out = out.astype(np.float64)
    return out


def _fetch_full_triu(c, nnz: int):
    """Download a fully-dense upper-triangular product as values only.

    Device: staircase extraction (the existing triu CSR pipeline), then the
    values array alone crosses the link (fine-trimmed, chunked).  Host:
    indices are reconstructed arithmetically (row i holds columns i..n-1).
    """
    from .types import _trim_to
    from .utils.transfer import fetch_np, fine_capacity

    m = c.shape[0]
    csr = _extract_csr(c, bucket_capacity(nnz), symmetric=True)
    indptr = np.asarray(csr.indptr)
    if int(indptr[-1]) != nnz:
        # Runtime data invariant (not a debug assert: must survive -O): the
        # arithmetic index reconstruction below is only valid for a fully
        # dense upper triangle.
        raise RuntimeError(
            f"triu extraction produced {int(indptr[-1])} entries, expected {nnz}"
        )
    cap = csr.capacity
    fine = min(fine_capacity(nnz), cap)
    val_d = csr.values
    if fine < cap:
        _, val_d = _trim_to(csr.indices, csr.values, fine)
    values = fetch_np(val_d)[:nnz].astype(np.float64)
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(m, dtype=np.int64), counts)
    indices = (
        np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1].astype(np.int64), counts) + rows
    ).astype(np.int32)
    return csr_matrix((values, indices, indptr), shape=(m, m))


def _chunk_rows_padded(a_sp, start: int, stop: int, rows_pad: int, dtype=None):
    """Rows [start, stop) of a scipy CSR as a device CSRMatrix with
    ``rows_pad`` rows (trailing rows empty) -- row counts are bucketed so
    chunks of similar size share one compiled executable."""
    sub = a_sp[start:stop]
    indptr = np.zeros(rows_pad + 1, dtype=np.int32)
    indptr[: stop - start + 1] = sub.indptr
    indptr[stop - start + 1 :] = sub.indptr[-1]
    padded = sp.csr_matrix(
        (sub.data, sub.indices, indptr), shape=(rows_pad, a_sp.shape[1])
    )
    return from_scipy(padded, dtype=dtype)


def _flop_chunk_bounds(flops: np.ndarray, expand_limit: int, max_rows: int):
    """Contiguous row-chunk boundaries with ~``expand_limit`` partial
    products per chunk and at most ``max_rows`` rows per chunk.

    The flop-balanced replacement for the reference's equal-count ``limits``
    partitioning (``/root/reference/src/workdivision.cpp:45-86``) + its
    ``schedule(dynamic)`` runtime rebalancing.  A single row heavier than
    ``expand_limit`` becomes its own chunk (capacity is sized to the actual
    flops downstream), so the walk always advances: termination is by
    construction, not by luck.
    """
    m = len(flops)
    csum = np.concatenate([[0.0], np.cumsum(flops, dtype=np.float64)])
    bounds = [0]
    while bounds[-1] < m:
        start = bounds[-1]
        stop = int(np.searchsorted(csum, csum[start] + expand_limit, "right")) - 1
        stop = min(max(stop, start + 1), start + max_rows, m)
        bounds.append(stop)
    return bounds


def _sparse_out_chunked_esc(a_sp, b_sp, symmetric: bool, esc_limit=None):
    """Flop-balanced row-chunked ESC: the large-sparse driver.

    Handles any size/density whose *operands and output chunks* fit device
    memory -- the regime the reference's grow-on-demand Gustavson core covers
    within host RAM (``/root/reference/src/sparsework.cpp:12-149``).  Unlike
    the dense path it never materializes a (k, n) panel, so B wider than
    ``dense_path_limit`` is fine.
    """
    from .parallel.partition import row_flops

    m, k = a_sp.shape
    n = b_sp.shape[1]
    cfg = get_config()
    flops = row_flops(a_sp.indptr, a_sp.indices, b_sp.indptr)
    # Chunk size is bounded by the flop budget alone: the two-key (row,
    # col) ESC sort removed the old int32-key rows_pad * n < 2**31 cap.
    # ``esc_limit`` carries the caller's ``imem_size`` working-memory hint
    # (reference: /root/reference/src/sparse_sparse_sparse.cpp:69-80).
    bounds = _flop_chunk_bounds(flops, esc_limit or cfg.esc_expand_limit, m)

    # Policy dtype (f32 under FAST, else f64); stitch_csr returns f64.
    dtype = policy_dtype()
    b = from_scipy(b_sp, dtype=dtype)
    csum = np.concatenate([[0], np.cumsum(flops, dtype=np.int64)])
    # One window plan for the WHOLE operand (not per chunk): chunks then
    # share compiled executables, and B's row-length profile is chunk-
    # independent anyway.  Per-chunk tail capacities are exact-then-bucketed.
    ref_lens = np.diff(b_sp.indptr)[a_sp.indices]
    total_expand = int(csum[-1])
    plan = windowed_plan(a_sp.nnz, ref_lens, total_expand)
    tail_cum = (
        np.concatenate(
            [[0], np.cumsum(np.maximum(ref_lens - plan[0], 0), dtype=np.int64)]
        )
        if plan is not None
        else None
    )
    parts = []
    for start, stop in zip(bounds[:-1], bounds[1:]):
        rows_c = stop - start
        rows_pad = min(bucket_capacity(rows_c, minimum=1), bucket_capacity(m, minimum=1))
        expand = int(csum[stop] - csum[start])
        a_chunk = _chunk_rows_padded(a_sp, start, stop, rows_pad, dtype=dtype)
        out_cap = bucket_capacity(max(min(expand, rows_pad * n), 1))
        if plan is not None:
            e0, e1 = a_sp.indptr[start], a_sp.indptr[stop]
            tail = int(tail_cum[e1] - tail_cum[e0])
            c = spgemm_esc_windowed(
                a_chunk,
                b,
                window=plan[0],
                expand_capacity=bucket_capacity(max(expand, 1)),
                tail_capacity=bucket_capacity(tail) if tail else 0,
                out_capacity=out_cap,
                symmetric=symmetric,
                row_offset=jnp.int32(start),
            )
        else:
            c = spgemm_esc(
                a_chunk,
                b,
                expand_capacity=bucket_capacity(max(expand, 1)),
                out_capacity=out_cap,
                symmetric=symmetric,
                row_offset=jnp.int32(start),
            )
        parts.append(to_scipy(c)[:rows_c])
    out = stitch_csr(parts, m, n)
    if out.dtype != np.float64:  # numpy-fallback stitch keeps f32
        out = out.astype(np.float64)
    _set_route("esc_chunks", chunks=len(bounds) - 1)
    return out


def _sparse_out_chunked_dense(a_sp, b_sp, symmetric: bool):
    """Row-chunked dense path: B's (k, n) panel fits on device but A (or the
    output) does not.  Chunk rows equally -- dense product cost per chunk is
    rows*k*n regardless of sparsity, so equal rows IS the flop balance here.
    Each chunk runs the single-shot dense pipeline directly (never recurses).
    """
    m, k = a_sp.shape
    n = b_sp.shape[1]
    limit = get_config().dense_path_limit
    chunk = max(1, min(m, limit // max(n, 1)))
    parts = []
    for start in range(0, m, chunk):
        stop = min(start + chunk, m)
        parts.append(_dense_to_scipy_csr(a_sp[start:stop], b_sp, False))
    out = stitch_csr(parts, m, n)
    if symmetric:
        out = csr_triu(out)
    return out


_LINK_CALIBRATED = False


def _calibrate_link() -> None:
    """Measure the device link once and store it in the config.

    Dispatch latency: minimum wall time of a trivial jitted call with a
    blocking scalar fetch.  Bandwidth: a 2 MiB transfer each way, net of
    that latency.
    """
    global _LINK_CALIBRATED
    _LINK_CALIBRATED = True
    import time as _time

    try:
        triv = jax.jit(lambda x: x + 1.0)
        float(triv(jnp.float32(1.0)))
        rtts = []
        for _ in range(3):
            t0 = _time.perf_counter()
            float(triv(jnp.float32(1.0)))
            rtts.append(_time.perf_counter() - t0)
        rtt = min(rtts)
        # Each fetch must hit a FRESH device array: jax Arrays cache their
        # host copy, so re-fetching the same buffer measures nothing.
        nbytes = 2 << 20
        f = jax.jit(lambda x: x * 2.0)
        x = jnp.ones(nbytes // 4, jnp.float32)
        np.asarray(f(x))  # warm the executable
        t0 = _time.perf_counter()
        np.asarray(f(x))
        dt = _time.perf_counter() - t0
        down_bw = nbytes / max(dt - rtt, 1e-5)
        # Upload direction.
        h = np.ones(nbytes // 4, np.float32)
        jax.device_put(h).block_until_ready()  # warm the path
        t0 = _time.perf_counter()
        jax.device_put(h).block_until_ready()
        dt = _time.perf_counter() - t0
        up_bw = nbytes / max(dt - rtt, 1e-5)
        from .config import set_config

        set_config(
            link_fixed_s=max(rtt, 1e-5),
            link_up_bytes_per_s=max(up_bw, 1e6),
            link_down_bytes_per_s=max(down_bw, 1e6),
        )
    except Exception:  # calibration is best-effort; defaults stand
        pass


def _est_result_nnz(expand: int, m: int, n: int) -> int:
    """Expected nnz(C) from the partial-product count under a random
    collision model: each of ``expand`` partials lands uniformly in the
    m*n output slots, so a slot is hit with prob 1-exp(-expand/(m*n)).
    Exact in both limits (hypersparse: nnz ~= expand; dense: nnz ~= m*n)."""
    slots = max(m * n, 1)
    return int(slots * (1.0 - np.exp(-expand / slots)))


def _host_route_wins(expand: int, a_sp, b_sp, out_bytes: int | None = None) -> bool:
    """Cost model: host Gustavson vs device round trip, for scipy-in/out.

    The device path pays a fixed dispatch latency plus operand upload and
    result download over the host<->device link (modeled per direction);
    the host path costs
    ``partials / host_rate``.  The download term uses the cheaper of the
    two result encodings the dense route can ship (raw f32 panel vs packed
    CSR -- see ``_dense_to_scipy_csr``).  The reference hard-codes the
    equivalent judgement call as documentation ("serial mode: use
    scipy/MKL", ``/root/reference/README.md:16-17``); here it is an
    explicit, calibratable scheduler decision.  Device-native entry points
    never route here.
    """
    cfg = get_config()
    if cfg.auto_calibrate_link and not _LINK_CALIBRATED:
        _calibrate_link()
        cfg = get_config()
    m = a_sp.shape[0]
    n = b_sp.shape[1]
    # Per-entry wire bytes follow the upload dtype: f64 values make
    # entries 12 B each way, f32 (FAST) 8 B.
    val_bytes = 4 if policy_dtype() == jnp.float32 else 8
    entry_bytes = 4 + val_bytes  # int32 index + value
    nnz_est = _est_result_nnz(expand, m, n)
    if out_bytes is None:
        # Sparse output: cheaper of packed CSR (fine-trimmed) and the raw
        # dense panel + host pack.
        csr_bytes = entry_bytes * nnz_est
        panel_cost = (
            val_bytes * m * n / cfg.link_down_bytes_per_s + m * n / cfg.host_pack_rate
        )
        down_cost = min(csr_bytes / cfg.link_down_bytes_per_s, panel_cost)
    else:
        down_cost = out_bytes / cfg.link_down_bytes_per_s
    out_slots = max(nnz_est, 1)
    reuse = max(expand / out_slots, 1.0)
    est_host = expand / (cfg.host_rate_base * reuse**0.5)
    up_bytes = entry_bytes * (a_sp.nnz + b_sp.nnz)
    est_dev = cfg.link_fixed_s + up_bytes / cfg.link_up_bytes_per_s + down_cost
    return est_host < est_dev


def _sparse_out_host(a_sp, b_sp, symmetric: bool, esc_limit=None):
    """sparse x sparse -> scipy CSR, choosing the device strategy by size.

    Strategy ladder (first match wins):

    0. tiny problem                   -> native host Gustavson (OpenMP)
    1. everything fits densely        -> single dense product + extraction
    2. few partial products           -> single ESC dispatch
    3. B panel fits densely           -> equal-row dense chunks
    4. otherwise                      -> flop-balanced ESC chunks
    """
    m, k = a_sp.shape
    n = b_sp.shape[1]

    expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    cfg = get_config()
    # keep_structure bans the route that drops computed-exact-zero entries
    # (dense extraction): host and ESC preserve Gustavson structure.
    keep = cfg.keep_structure
    if expand <= cfg.host_compute_limit or _host_route_wins(expand, a_sp, b_sp):
        out = spgemm_host(
            a_sp, b_sp, symmetric, n_partials=expand, keep_structure=keep
        )
        _set_route("host")
        return out

    # Expansion much smaller than the dense panel: the binned ESC engine
    # never materializes the (m, n) panel.
    budget = esc_limit or get_config().esc_expand_limit
    # The binned 2D engine sustains a much larger single dispatch than the
    # device-wide 1D engines (per-lane working set, no device-wide sorts):
    # its budget scales from the base one so an ``imem_size`` hint shrinks
    # or grows both proportionally.
    binned_budget = 0
    if cfg.use_binned_esc:
        binned_budget = int(
            cfg.binned_expand_limit * (budget / cfg.esc_expand_limit)
        )
    sparse_wins = expand <= max(budget, binned_budget) and 4 * expand <= m * n
    if dense_path_fits((m, k), (k, n), (m, n)) and not keep and not sparse_wins:
        return _dense_to_scipy_csr(a_sp, b_sp, symmetric)
    if expand <= max(budget, binned_budget):
        # Expansion-sort: exact structure (keeps Gustavson's structural
        # zeros), capacities exact-then-bucketed; the two-key (row, col)
        # sort has no m*n size limit.  Upload in the policy dtype.
        dtype = policy_dtype()
        if expand <= binned_budget:
            # Row-binned 2D engine first: per-lane sorts in place of the
            # device-wide sorts of the windowed/classic engines.
            from .ops.spgemm_binned import binned_plan, spgemm_esc_binned

            bplan = binned_plan(
                a_sp.indptr,
                a_sp.indices,
                b_sp.indptr,
                window=cfg.binned_window,
                lane_width=cfg.binned_lane_width,
            )
            if bplan is not None:
                a = from_scipy(a_sp, dtype=dtype)
                b = from_scipy(b_sp, dtype=dtype)
                c = spgemm_esc_binned(
                    a,
                    b,
                    *bplan.device_args(),
                    window=bplan.window,
                    out_capacity=bucket_capacity(min(expand, m * n)),
                    symmetric=symmetric,
                    dedup_span=bplan.max_run,
                )
                _set_route("esc_binned")
                out = to_scipy(c)
                if out.dtype != np.float64:
                    out = out.astype(np.float64)
                return out
        if expand > budget:
            # Binned plan refused the layout and the expansion exceeds the
            # 1D engines' dispatch budget: fall through to the chunked path.
            return _sparse_out_chunked_esc(a_sp, b_sp, symmetric, esc_limit)
        a = from_scipy(a_sp, dtype=dtype)
        b = from_scipy(b_sp, dtype=dtype)
        out_cap = bucket_capacity(min(expand, m * n))
        plan = windowed_plan(
            a_sp.nnz, np.diff(b_sp.indptr)[a_sp.indices], expand
        )
        if plan is not None:
            w, tail = plan
            c = spgemm_esc_windowed(
                a,
                b,
                window=w,
                expand_capacity=bucket_capacity(expand),
                tail_capacity=bucket_capacity(tail) if tail else 0,
                out_capacity=out_cap,
                symmetric=symmetric,
            )
            _set_route("esc_windowed")
        else:
            c = spgemm_esc(
                a,
                b,
                expand_capacity=bucket_capacity(expand),
                out_capacity=out_cap,
                symmetric=symmetric,
            )
            _set_route("esc")
        out = to_scipy(c)
        if out.dtype != np.float64:
            out = out.astype(np.float64)
        return out

    if dense_path_fits((k, n)) and not keep:
        out = _sparse_out_chunked_dense(a_sp, b_sp, symmetric)
        _set_route("dense_chunks")
        return out

    return _sparse_out_chunked_esc(a_sp, b_sp, symmetric, esc_limit=esc_limit)


def _zero_notice(result):
    if not get_config().zero_result_notice:
        return
    if isinstance(result, np.ndarray) and np.all(result == 0):
        print("Multiplication resulted in a zero matrix.")
    elif sp.issparse(result) and result.nnz == 0:
        print("Multiplication resulted in a zero matrix.")


def sparse_matrix_multiply(
    matrix_a,
    matrix_b,
    output_format="sparse",
    symmetric=False,
    imem_size=None,
    use_triple_product=False,
    compute_full_matrix=None,
):
    """Multiply two sparse matrices on the device; reference-parity dispatcher.

    Parameters and dispatch mirror ``matrix_ops.py:271-368``:

    * ``output_format='sparse'`` -> scipy CSR (upper triangle only when
      ``symmetric=True``).
    * ``output_format='dense'``  -> numpy ndarray (upper triangle only when
      ``symmetric=True``).
    * ``use_triple_product=True``-> dense ``A . B . A^T`` (upper triangle, or
      mirrored-full with ``compute_full_matrix=1``); ``output_format`` is
      ignored, as in the reference.

    .. note:: structural zeros.  The reference's Gustavson workers KEEP an
       output entry whose accumulated value is exactly 0
       (``/root/reference/src/sparsework.cpp:73-110``); modern scipy
       (>= 1.14) prunes such entries in matmul.  Strategies here: the
       native-host Gustavson kernel and the ESC engines keep Gustavson
       structure; the scipy small-problem host branch and dense extraction
       prune.  For cancellation-prone inputs ``nnz`` of the sparse
       result can therefore depend on the route taken (values never do).
       Set ``config.keep_structure=True`` to pin reference-exact Gustavson
       structure on every sparse-output route.
    """
    # -- parameter normalization (parity with matrix_ops.py:290-305) --------
    if imem_size is None:
        imem_size = 5
    else:
        try:
            imem_size = int(imem_size)
        except (ValueError, TypeError):
            raise ValueError(
                f"imem_size must be an integer or None, got {type(imem_size)}"
            )
    # The reference treats imem_size in (0, 10] as a percent of per-thread
    # dense working memory and anything else as the default 10%
    # (/root/reference/src/sparse_sparse_sparse.cpp:69-80).  The device
    # analogue of "intermediate memory per work unit" is the per-dispatch
    # partial-product budget that sizes the flop-balanced row chunks:
    # scale Config.esc_expand_limit by imem_size/5 (5 = normalized default,
    # matrix_ops.py:290-297), floored so a chunk always holds real work.
    _pct = imem_size if 0 < imem_size <= 10 else 10
    esc_limit = max(1, get_config().esc_expand_limit * _pct // 5)

    if compute_full_matrix is None:
        compute_full_matrix = 0
    else:
        if compute_full_matrix not in (0, 1):
            raise ValueError("compute_full_matrix must be None, 0, or 1")
        compute_full_matrix = int(compute_full_matrix)

    matrix_a = _coerce_csr(matrix_a)
    matrix_b = _coerce_csr(matrix_b)

    if matrix_a.shape[1] != matrix_b.shape[0]:
        raise ValueError("Matrix dimensions are incompatible for multiplication.")

    # Empty-operand fast path (matrix_ops.py:315-319).
    if matrix_a.nnz == 0 or matrix_b.nnz == 0:
        _set_route("empty")
        if use_triple_product:
            return np.zeros((matrix_a.shape[0], matrix_a.shape[0]))
        if output_format == "sparse":
            return csr_matrix((matrix_a.shape[0], matrix_b.shape[1]))
        return np.zeros((matrix_a.shape[0], matrix_b.shape[1]))

    if symmetric and (matrix_a.shape[0] != matrix_b.shape[1]):
        raise ValueError("For symmetric output, the resulting matrix must be square.")

    if use_triple_product:
        if matrix_a.shape[1] != matrix_b.shape[1]:
            raise ValueError(
                "Triple product requires B.cols == A.cols so that (A.B).A^T "
                "is well defined."
            )
        m = matrix_a.shape[0]
        # Host route for small triple products: exact f64 via scipy, below
        # both the device dispatch floor AND the f32 cancellation risk --
        # mixed-sign operands can make FAST's f32 accumulation miss the
        # reference oracle's rtol=1e-5 where |C| << |A||Q||A|, and tiny
        # problems are where that matters most relative to cost (the
        # sparse/dense outputs already route host down here).
        expand = 2 * expansion_size(matrix_a.indices, matrix_a.nnz, matrix_b.indptr)
        _val_bytes = 4 if policy_dtype() == jnp.float32 else 8
        if expand <= get_config().host_compute_limit or _host_route_wins(
            expand, matrix_a, matrix_b, out_bytes=_val_bytes * m * m
        ):
            t = matrix_a @ matrix_b
            c = (t @ matrix_a.T).toarray()
            upper = np.triu(c)
            result = upper + np.triu(c, 1).T if compute_full_matrix else upper
            _set_route("host")
        else:
            from .utils.transfer import fetch_np

            dtype = policy_dtype()
            h = from_scipy(matrix_a, dtype=dtype)
            q = from_scipy(matrix_b, dtype=dtype)
            result = fetch_np(
                triple_product_dense(h, q, compute_full_matrix)
            ).astype(np.float64)
            _set_route("triple")
    elif output_format == "sparse":
        result = _sparse_out_host(matrix_a, matrix_b, symmetric, esc_limit=esc_limit)
    elif output_format == "dense":
        cfg = get_config()
        expand = expansion_size(matrix_a.indices, matrix_a.nnz, matrix_b.indptr)
        out_elems = matrix_a.shape[0] * matrix_b.shape[1]
        # Panel download bytes follow the upload dtype.
        _val_bytes = 4 if policy_dtype() == jnp.float32 else 8
        if expand <= cfg.host_compute_limit or _host_route_wins(
            expand, matrix_a, matrix_b, out_bytes=_val_bytes * out_elems
        ):
            result = spgemm_host(matrix_a, matrix_b, symmetric, n_partials=expand).toarray()
            _set_route("host")
        else:
            from .utils.transfer import fetch_np

            dtype = policy_dtype()
            a = from_scipy(matrix_a, dtype=dtype)
            b = from_scipy(matrix_b, dtype=dtype)
            result = fetch_np(
                _dense_product_only(a, b, symmetric)
            ).astype(np.float64)
            _set_route("dense")
    else:
        raise ValueError("Invalid output_format. Choose 'sparse' or 'dense'.")

    _zero_notice(result)
    return result


# ---------------------------------------------------------------------------
# Device-native API (jit-composable; CSRMatrix in -> CSRMatrix/dense out).
# ---------------------------------------------------------------------------

def multiply(
    a: CSRMatrix,
    b: CSRMatrix,
    *,
    output_format: str = "sparse",
    symmetric: bool = False,
    out_capacity: int | None = None,
    expand_capacity: int | None = None,
    precision: str | None = None,
    window: int | None = None,
    tail_capacity: int = 0,
    b_table=None,
    plan=None,
):
    """Device-resident multiply for JAX programs (composable under ``jit``).

    Sparse output requires static capacities (XLA static shapes); see
    :func:`sparse_matrix_mult_tpu.ops.spgemm_jnp.spgemm_esc`.

    .. note:: small problems.  For small/mid sparse outputs pass ``plan=``
       (:func:`ops.spgemm_binned.binned_plan`) to run the row-binned
       engine instead of the dense-panel + extraction route.
       :func:`sparse_matrix_multiply` routes small problems to the host
       automatically, while this entry point deliberately never leaves
       the device (it is meant to compose inside larger jitted programs
       where the result stays in device memory).

    .. warning:: ``window`` sizing.  With ``window`` set, B rows longer
       than the window spill into the tail expansion; an undersized
       ``tail_capacity`` (the default 0 means "no B row exceeds the
       window") silently DROPS those partials -- no device-side error is
       possible under static shapes.  Always size ``window``/
       ``tail_capacity`` with :func:`ops.spgemm_jnp.windowed_plan` (or
       guarantee max B row nnz <= window).
    """
    if output_format == "dense":
        return spgemm_dense_out(a, b, symmetric=symmetric, precision=precision)
    if output_format == "sparse":
        if out_capacity is None:
            raise ValueError("sparse output under jit requires out_capacity")
        if plan is not None:
            # Row-binned 2D engine with a host-built structure plan
            # (ops.spgemm_binned.binned_plan) -- the fastest sparse-output
            # path when the layout fits; plan once per operand structure,
            # reuse across every multiply.
            from .ops.spgemm_binned import spgemm_esc_binned

            return spgemm_esc_binned(
                a,
                b,
                *plan.device_args(),
                window=plan.window,
                out_capacity=out_capacity,
                symmetric=symmetric,
                dedup_span=plan.max_run,
            )
        if expand_capacity is None and (window is not None or b_table is not None):
            raise ValueError(
                "window/b_table require expand_capacity: without it the "
                "call would fall through to the dense-out extraction path, "
                "which prunes structural zeros and materializes a dense "
                "panel (different semantics)"
            )
        if expand_capacity is not None:
            if window is not None:
                # Windowed (ELLPACK) expansion: the hypersparse fast path.
                # Callers size window/tail from host structure stats (see
                # ops.spgemm_jnp.windowed_plan); exact for any skew via the
                # tail spill.  ``b_table`` (precompute_window_table) skips
                # the per-call table build when B is reused.
                return spgemm_esc_windowed(
                    a,
                    b,
                    window=window,
                    expand_capacity=expand_capacity,
                    tail_capacity=tail_capacity,
                    out_capacity=out_capacity,
                    symmetric=symmetric,
                    b_table=b_table,
                )
            return spgemm_esc(
                a,
                b,
                expand_capacity=expand_capacity,
                out_capacity=out_capacity,
                symmetric=symmetric,
            )
        c = spgemm_dense_out(a, b, symmetric=symmetric, precision=precision)
        if symmetric and c.shape[0] == c.shape[1]:
            from .ops.convert import dense_to_csr_triu

            return dense_to_csr_triu(c, out_capacity)
        return dense_to_csr(c, out_capacity)
    raise ValueError("Invalid output_format. Choose 'sparse' or 'dense'.")


def triple_product(h: CSRMatrix, q: CSRMatrix, compute_full_matrix: int = 0, precision=None):
    """Device-resident fused ``H . Q . H^T`` (see ops.triple_product)."""
    return triple_product_dense(h, q, compute_full_matrix, precision=precision)
