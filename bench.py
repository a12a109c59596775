"""Headline benchmark: the reference README's published config, on a GPU.

sparse x sparse -> symmetric product, 10,000 x 10,000, density 0.1
(``/root/reference/README.md:216-220``): the reference's OpenMP CSR SpGEMM
does it in 11.4803 s on an M1 (scipy: 16.6 s).  This times the
device-resident path (operands already on device, result left on device):
densify, upper-triangular product under ``precision="fast"``, and
upper-triangle extraction to packed CSR.  It reports nnz(C)/s with
``vs_baseline`` = speedup over the reference's published wall time.

Exits non-zero without a GPU.  Prints exactly one JSON line.
"""

import json
import statistics
import sys
import time

import scipy.sparse as sp

import jax
import jax.numpy as jnp

import sparse_matrix_mult_tpu as smm
from sparse_matrix_mult_tpu.ops.convert import dense_to_csr_triu
from sparse_matrix_mult_tpu.ops.dense_path import spgemm_dense_out
from sparse_matrix_mult_tpu.utils.transfer import fine_capacity

REF_SECONDS = 11.4803  # /root/reference/README.md:216-220 (M1, OpenMP)
N = 10_000
DENSITY = 0.1
ITERS = 5


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform}")
    a_sp = sp.random(N, N, density=DENSITY, format="csr", random_state=1)
    b_sp = sp.random(N, N, density=DENSITY, format="csr", random_state=2)

    # Fine operand capacities (<=1/16 padding instead of the power-of-two
    # default's 1.67x here): the conversions process capacity-sized arrays.
    a = smm.from_scipy(a_sp, dtype=jnp.float32, capacity=fine_capacity(a_sp.nnz))
    b = smm.from_scipy(b_sp, dtype=jnp.float32, capacity=fine_capacity(b_sp.nnz))
    cap = fine_capacity((N * N + N) // 2)

    @jax.jit
    def step(a, b):
        c = spgemm_dense_out(a, b, symmetric=True, precision="fast")
        return dense_to_csr_triu(c, cap)

    out = jax.block_until_ready(step(a, b))  # warm-up / compile
    nnz_c = int(out.indptr[-1])
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(step(a, b))
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    print(
        json.dumps(
            {
                "metric": "spgemm_sym_10k_d0.1_nnz_per_s",
                "value": nnz_c / t,
                "unit": "nnz(C)/s",
                "vs_baseline": REF_SECONDS / t,
                "seconds": t,
                "nnz_c": nnz_c,
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
            }
        )
    )


if __name__ == "__main__":
    main()
