"""Weak-scaling harness for the distributed ring SpGEMM.

The reference scales only across OpenMP threads in one address space; its
"scaling report" is nonexistent (SURVEY section 6).  This harness measures
the new framework's scale-out dimension: a 1D device mesh with row-sharded
A/C and ring-rotated B blocks (``parallel/distributed.py``).

Weak scaling: each device receives a fixed per-device problem (rows_per_chip
rows of A and the matching share of B columns' contraction work), so perfect
scaling keeps wall time flat as devices are added.  Efficiency(n) =
T(1) / T(n).

On a CPU host this runs on a virtual device mesh
(``--xla_force_host_platform_device_count``), which exercises the identical
shard_map/ppermute program XLA compiles for a multi-GPU mesh; the absolute
times are then host-bound, but the collective/sharding overheads are real.
On several GPUs it measures the real interconnect's scaling.

Usage::

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py --rows-per-chip 512 --density 0.1

Prints one JSON report with per-n timings and efficiencies.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-chip", type=int, default=512)
    ap.add_argument("--cols", type=int, default=2048)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument(
        "--mode",
        choices=["auto", "weak", "overhead", "breakdown"],
        default="auto",
        help="weak: per-chip problem fixed, T(n) flat is perfect (real "
        "multi-chip); overhead: total problem fixed, T(n)/T(1) measures "
        "sharding+collective overhead (virtual CPU mesh); breakdown: weak "
        "sizing, but each point ALSO times the comm-disabled twin of the "
        "ring (ppermute replaced by identity, identical per-shard FLOPs) "
        "-- comm overhead = T_ring - T_compute, separated from host "
        "contention, with comm efficiency = T_compute / T_ring the "
        "mesh-controlled number",
    )
    ap.add_argument(
        "--cpu-mesh",
        action="store_true",
        help="force a virtual CPU device mesh",
    )
    args = ap.parse_args()

    if args.cpu_mesh or os.environ.get("JAX_PLATFORMS", "") == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from sparse_matrix_mult_tpu.parallel.distributed import (
        _spgemm_dense_jit,
        shard_csr,
    )
    from sparse_matrix_mult_tpu.parallel.mesh import row_mesh

    devices = jax.devices()
    counts = [n for n in (1, 2, 4, 8, 16) if n <= len(devices)]
    mode = args.mode
    if mode == "auto":
        # Virtual CPU meshes share one host's FLOPs: weak scaling (work grows
        # with n) cannot be flat there, so measure sharding/collective
        # *overhead* at fixed total work instead.  Real multi-chip meshes get
        # true weak scaling.
        mode = "overhead" if jax.default_backend() == "cpu" else "weak"
    def time_fn(fn, a, b):
        float(fn(a, b))  # compile + warm
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            float(fn(a, b))
            times.append(time.perf_counter() - t0)
        return min(times)

    results = []
    for n in counts:
        mesh = row_mesh(devices[:n])
        m = args.rows_per_chip * (
            n if mode in ("weak", "breakdown") else max(counts)
        )
        k = args.cols
        a_sp = sp.random(m, k, density=args.density, format="csr", random_state=1)
        b_sp = sp.random(k, k, density=args.density, format="csr", random_state=2)
        # Sharded ingestion (one block per device); the timed step covers
        # per-shard densify + the B-block ring + the MXU contractions --
        # exactly the production distributed pipeline.
        a = shard_csr(a_sp, mesh, dtype=jnp.float32)
        b = shard_csr(b_sp, mesh, dtype=jnp.float32)

        product = _spgemm_dense_jit(mesh, False)
        t_ring = time_fn(jax.jit(lambda a, b: jnp.sum(product(a, b))), a, b)
        row = {
            "devices": n,
            "rows": m,
            "cols": k,
            "seconds": round(t_ring, 5),
        }
        if mode == "breakdown":
            # Comm-disabled twin: the SAME shard_map program with ppermute
            # replaced by identity -- per-shard FLOPs, slices and
            # accumulations are identical, only ICI traffic is gone.  On a
            # time-shared virtual CPU mesh t_compute absorbs the host
            # contention that confounds raw weak scaling; the difference
            # is the ring communication the mesh actually controls.
            compute = _spgemm_dense_jit(mesh, False, comm=False)
            t_comp = time_fn(
                jax.jit(lambda a, b: jnp.sum(compute(a, b))), a, b
            )
            row["seconds_compute_only"] = round(t_comp, 5)
            row["comm_overhead_s"] = round(max(t_ring - t_comp, 0.0), 5)
            row["comm_efficiency"] = round(min(t_comp / t_ring, 1.0), 3)
        results.append(row)
        print(f"n={n}: {t_ring:.4f}s ({m}x{k} @ d={args.density})"
              + (f" compute-only {row['seconds_compute_only']:.4f}s"
                 f" comm-eff {row['comm_efficiency']}" if mode == "breakdown" else ""))

    t1 = results[0]["seconds"]
    key = (
        "weak_scaling_efficiency"
        if mode in ("weak", "breakdown")
        else "overhead_vs_1dev"
    )
    for r in results:
        r[key] = round(
            t1 / r["seconds"] if mode in ("weak", "breakdown") else r["seconds"] / t1,
            3,
        )

    report = {
        "benchmark": f"{mode}_scaling_ring_spgemm",
        "mode": mode,
        "backend": jax.default_backend(),
        "rows_per_chip": args.rows_per_chip,
        "density": args.density,
        "results": results,
    }
    out = json.dumps(report, indent=2)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)


if __name__ == "__main__":
    main()
