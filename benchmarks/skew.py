"""Skewed-matrix benchmark: flop-balanced vs equal-rows chunking.

The reference partitions rows into contiguous equal-COUNT ranges
(``limits``, ``/root/reference/src/workdivision.cpp:45-86``) and papers over
the resulting imbalance with OpenMP ``schedule(dynamic)``
(``sparse_sparse_sparse.cpp:233``).  Device dispatches are static, so this
framework balances chunk boundaries by *flops* (partial products) instead
(:func:`sparse_matrix_mult_tpu.api._flop_chunk_bounds`).

This harness makes the difference measurable: a power-law (Zipf) row-nnz
matrix is multiplied through the chunked large-sparse ESC driver twice --
once with the production flop-balanced bounds, once with equal-row bounds of
the same chunk count (the reference's ``limits`` semantics).  Equal-row
chunks on a skewed matrix concentrate most partial products into a few huge
dispatches whose padded capacities (power-of-two buckets) blow up, while the
remaining dispatches run nearly empty; flop-balanced bounds keep every
dispatch near the target expansion so capacity buckets are shared and
recompiles amortize.

Usage::

    python benchmarks/skew.py [--rows 40000] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import sparse_matrix_mult_tpu as smm
from sparse_matrix_mult_tpu import api
from sparse_matrix_mult_tpu.parallel.partition import (
    equal_rows_partition,
    row_flops,
)
from sparse_matrix_mult_tpu.types import bucket_capacity
from sparse_matrix_mult_tpu.ops.spgemm_jnp import spgemm_esc
from sparse_matrix_mult_tpu.types import from_scipy, to_scipy
from sparse_matrix_mult_tpu.utils.native import stitch_csr


def zipf_csr(rows: int, cols: int, nnz_target: int, alpha: float, seed: int):
    """CSR matrix whose row-nnz profile follows a Zipf law (few hub rows).

    Vectorized: sample (row, col) pairs with Zipf row probabilities; COO
    conversion sums the few duplicate hits, which only perturbs values.
    """
    rng = np.random.default_rng(seed)
    weights = (1.0 + np.arange(rows, dtype=np.float64)) ** (-alpha)
    rng.shuffle(weights)
    r_idx = rng.choice(rows, size=nnz_target, p=weights / weights.sum())
    c_idx = rng.integers(0, cols, size=nnz_target)
    data = rng.uniform(size=nnz_target)
    return sp.coo_matrix((data, (r_idx, c_idx)), shape=(rows, cols)).tocsr()


def run_chunked(a_sp, b_sp, bounds, label: str) -> float:
    """One chunked-ESC pass over explicit row-chunk bounds (timed)."""
    m, k = a_sp.shape
    n = b_sp.shape[1]
    flops = row_flops(a_sp.indptr, a_sp.indices, b_sp.indptr)
    csum = np.concatenate([[0], np.cumsum(flops, dtype=np.int64)])
    b = from_scipy(b_sp)
    jax.block_until_ready((b.indptr, b.indices, b.values))

    t0 = time.perf_counter()
    parts = []
    for start, stop in zip(bounds[:-1], bounds[1:]):
        if stop <= start:
            continue
        rows_c = int(stop - start)
        rows_pad = bucket_capacity(rows_c, minimum=1)
        expand = int(csum[stop] - csum[start])
        a_chunk = api._chunk_rows_padded(a_sp, int(start), int(stop), rows_pad)
        out_cap = bucket_capacity(max(min(expand, rows_pad * n), 1))
        c = spgemm_esc(
            a_chunk,
            b,
            expand_capacity=bucket_capacity(max(expand, 1)),
            out_capacity=out_cap,
            symmetric=False,
            row_offset=jnp.int32(int(start)),
        )
        parts.append(to_scipy(c)[:rows_c])
    out = stitch_csr(parts, m, n)
    dt = time.perf_counter() - t0
    print(f"  {label:<14} chunks={len(bounds) - 1:3d}  {dt*1e3:9.1f} ms  nnz={out.nnz}")
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=40_000)
    ap.add_argument("--nnz", type=int, default=4_000_000)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    m = k = n = args.rows
    print(f"building Zipf operands ({m}x{k}, ~{args.nnz} nnz, alpha={args.alpha}) ...")
    a_sp = zipf_csr(m, k, args.nnz, args.alpha, seed=1)
    b_sp = sp.random(k, n, density=args.nnz / (k * n), format="csr", random_state=2)

    flops = row_flops(a_sp.indptr, a_sp.indices, b_sp.indptr)
    total = int(flops.sum())
    print(
        f"nnz(A)={a_sp.nnz}  nnz(B)={b_sp.nnz}  partial products={total}  "
        f"max-row share={flops.max() / max(total, 1):.2%}"
    )

    limit = smm.get_config().esc_expand_limit
    flop_bounds = np.asarray(api._flop_chunk_bounds(flops, limit, m), np.int64)
    n_chunks = len(flop_bounds) - 1
    equal_bounds = equal_rows_partition(m, n_chunks)

    # Warm both executables (compile time excluded from both sides).
    print("warming (compiles) ...")
    run_chunked(a_sp, b_sp, flop_bounds, "warm/flops")
    run_chunked(a_sp, b_sp, equal_bounds, "warm/equal")

    print("timed:")
    t_flops = min(run_chunked(a_sp, b_sp, flop_bounds, "flop-balanced") for _ in range(3))
    t_equal = min(run_chunked(a_sp, b_sp, equal_bounds, "equal-rows") for _ in range(3))

    gain = t_equal / t_flops
    report = {
        "benchmark": "skewed_chunking",
        "backend": jax.default_backend(),
        "rows": m,
        "nnz_a": int(a_sp.nnz),
        "partial_products": total,
        "alpha": args.alpha,
        "chunks": int(n_chunks),
        "seconds_flop_balanced": round(t_flops, 5),
        "seconds_equal_rows": round(t_equal, 5),
        "gain": round(gain, 3),
    }
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
