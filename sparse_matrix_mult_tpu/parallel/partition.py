"""Work partitioning across devices.

Device-side counterpart of the reference's entire scheduling layer, the
``limits()`` row partitioner (``/root/reference/src/workdivision.cpp:16-89``),
which splits rows into contiguous equal-*count* ranges.  Equal row counts
load-imbalance skewed matrices, so the primary partitioner here balances by
**flops** (number of partial products per row), the quantity the OpenMP
``schedule(dynamic)`` clauses in the reference were compensating for at
runtime (``sparse_sparse_sparse.cpp:233``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["equal_rows_partition", "flop_balanced_partition", "row_flops"]


def equal_rows_partition(rows: int, parts: int) -> np.ndarray:
    """Contiguous equal-count row ranges; remainder spread one-per-part.

    Semantics-parity with ``limits`` (``workdivision.cpp:45-86``), including
    clamping ``parts`` to ``rows`` (``:26-29``).  Returns ``(parts+1,)`` range
    boundaries instead of the reference's two-column start/end table.
    """
    parts = max(1, min(parts, rows)) if rows > 0 else 1
    base, rem = divmod(rows, parts)
    sizes = np.full(parts, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def row_flops(a_indptr, a_indices, b_indptr) -> np.ndarray:
    """Partial products contributed by each row of A (host; native OpenMP
    library when available, numpy fallback otherwise)."""
    from ..utils.native import row_flops as _native_row_flops

    return _native_row_flops(a_indptr, a_indices, b_indptr)


def flop_balanced_partition(flops: np.ndarray, parts: int) -> np.ndarray:
    """Contiguous row ranges with near-equal total flops.

    Greedy prefix-sum split: boundary ``i`` is placed where cumulative flops
    crosses ``i/parts`` of the total.  Returns ``(parts+1,)`` boundaries.
    """
    rows = len(flops)
    if rows == 0 or parts <= 1:
        return np.array([0, rows], dtype=np.int64)
    parts = min(parts, rows)
    csum = np.cumsum(np.maximum(np.asarray(flops, dtype=np.float64), 1e-9))
    targets = csum[-1] * np.arange(1, parts) / parts
    cuts = np.searchsorted(csum, targets, side="left") + 1
    bounds = np.concatenate([[0], cuts, [rows]])
    # Enforce monotonicity (degenerate flop profiles can collapse cuts).
    return np.maximum.accumulate(np.minimum(bounds, rows)).astype(np.int64)
