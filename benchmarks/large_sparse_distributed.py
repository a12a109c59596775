"""SURVEY section-5 target workload: a 1M x 1M hypersparse product across
the mesh with the sparse local contraction -- nothing densified anywhere.

A 1M x 1M d=1e-5 operand is ~120 MB as CSR but its dense shard panels
would be ~0.5 TB per device (f32, 8 shards): only the sparse engine
(``spgemm_csr_distributed_sparse``) can run it.  This harness executes the
full pipeline -- flop-balanced sharded ingest, CSR ring, per-shard
expand/lex-sort/compress, host stitch -- on the default backend's devices
(or, with ``--cpu-mesh``, a virtual 8-device CPU mesh running the same
program) and differentially checks the result against scipy.

Usage::

    python benchmarks/large_sparse_distributed.py --cpu-mesh --rows 100000 \
        --nnz 1000000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from sparse_matrix_mult_tpu.utils.testing import hypersparse_random as hypersparse  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--nnz", type=int, default=10_000_000)
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="run on a virtual 8-device CPU mesh")
    args = ap.parse_args()

    if args.cpu_mesh:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax

    from sparse_matrix_mult_tpu.parallel.distributed import (
        spgemm_csr_distributed_sparse,
    )
    from sparse_matrix_mult_tpu.parallel.mesh import row_mesh

    m = args.rows
    print(f"building {m}x{m} operands with ~{args.nnz} nnz each ...", flush=True)
    A = hypersparse(m, m, args.nnz, 51)
    B = hypersparse(m, m, args.nnz, 52)

    t0 = time.perf_counter()
    ref = A @ B
    t_scipy = time.perf_counter() - t0
    print(f"scipy: {t_scipy:.1f} s, nnz(C)={ref.nnz}", flush=True)

    mesh = row_mesh()
    S = mesh.devices.size
    dense_panel_gb = (m / S) * m * 4 / 1e9

    t0 = time.perf_counter()
    out = spgemm_csr_distributed_sparse(A, B, mesh=mesh, balance="flops")
    jax.block_until_ready((out.indptrs, out.indices, out.values))
    t_first = time.perf_counter() - t0  # includes compile + ingest
    t0 = time.perf_counter()
    out = spgemm_csr_distributed_sparse(A, B, mesh=mesh, balance="flops")
    jax.block_until_ready((out.indptrs, out.indices, out.values))
    t_warm = time.perf_counter() - t0  # ingest + compute (compile cached)

    t0 = time.perf_counter()
    got = out.to_scipy()
    t_stitch = time.perf_counter() - t0

    assert got.nnz == ref.nnz, (got.nnz, ref.nnz)
    err = abs(got - ref).max()
    assert err < 1e-8, err

    report = {
        "benchmark": "large_sparse_distributed",
        "backend": jax.default_backend(),
        "devices": S,
        "rows": m,
        "nnz_a": int(A.nnz),
        "nnz_c": int(ref.nnz),
        "dense_shard_panel_gb": round(dense_panel_gb, 1),
        "seconds_first_call": round(t_first, 2),
        "seconds_warm": round(t_warm, 2),
        "seconds_stitch_to_scipy": round(t_stitch, 2),
        "scipy_seconds": round(t_scipy, 2),
        "max_abs_err": float(err),
        "exact_structure": True,
    }
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
