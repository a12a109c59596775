"""Time the device CSR <-> dense conversions and their bandwidth roofline share.

At the reference's headline size (10,000^2, d=0.1) this times, each as its
own jitted program on device-resident data (median of 5 runs after a
warm-up, each ending in ``block_until_ready``):

* ``csr_to_dense``      -- the distribute network (ops/convert.py),
* ``dense_to_csr``      -- per-row counts + the packing network,
* ``dense_to_csr_triu`` -- the same on an upper-triangular panel,

plus the one-op XLA forms they replace below ``_SMALL`` (scatter-add
``CSRMatrix.todense`` and ``types.from_dense``'s ``nonzero(size=)``).
The roofline time is the bytes each must move (read its input once, write
its output once) over the card's published bandwidth.  Exits non-zero
without a GPU, or on a device kind missing from the peak table.

Usage::

    python benchmarks/convert.py [--n 10000] [--density 0.1]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import sparse_matrix_mult_tpu as smm
from sparse_matrix_mult_tpu.ops.convert import csr_to_dense, dense_to_csr, dense_to_csr_triu
from sparse_matrix_mult_tpu.types import from_dense

# Published device-memory bandwidth, bytes/s (NVIDIA H100 SXM data sheet).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _time(fn, *args, reps: int = 5) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--density", type=float, default=0.1)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"convert.py measures the GPU; JAX found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"# {smi}; {dev.device_kind} x{len(jax.devices())}; jax {jax.__version__}")

    n = args.n
    a_sp = sp.random(n, n, density=args.density, format="csr", random_state=1)
    rows = []
    for dtype in (jnp.float32, jnp.float64):
        item = np.dtype(dtype).itemsize
        a = smm.from_scipy(a_sp, dtype=dtype)
        cap = a.capacity
        dense = csr_to_dense(a)
        triu = jnp.triu(dense)
        nnz_triu = int(jnp.count_nonzero(triu))
        csr_bytes = (n + 1) * 4 + cap * (4 + item)
        dense_bytes = n * n * item
        cases = [
            ("csr_to_dense", jax.jit(csr_to_dense), (a,), csr_bytes + dense_bytes),
            ("todense (scatter)", jax.jit(lambda x: x.todense()), (a,), csr_bytes + dense_bytes),
            ("dense_to_csr", jax.jit(lambda c: dense_to_csr(c, cap)), (dense,),
             dense_bytes + csr_bytes),
            ("from_dense (nonzero)", jax.jit(lambda c: from_dense(c, cap)), (dense,),
             dense_bytes + csr_bytes),
            ("dense_to_csr_triu", jax.jit(lambda c: dense_to_csr_triu(c, cap)), (triu,),
             dense_bytes + (n + 1) * 4 + nnz_triu * (4 + item)),
        ]
        for name, fn, fargs, nbytes in cases:
            t = _time(fn, *fargs)
            row = {"op": name, "dtype": np.dtype(dtype).name, "n": n, "nnz": a_sp.nnz,
                   "seconds": t, "bytes": nbytes, "device_kind": dev.device_kind}
            peak = PEAK_BYTES_PER_S.get(dev.device_kind)
            row["roofline_share"] = None if peak is None else (nbytes / peak) / t
            rows.append(row)
            print(json.dumps(row), flush=True)
    if dev.device_kind not in PEAK_BYTES_PER_S:
        sys.exit(f"device kind {dev.device_kind!r} is not in the peak table")


if __name__ == "__main__":
    main()
