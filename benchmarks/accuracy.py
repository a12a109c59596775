"""Accuracy report: precision policies and dot algorithms vs float64 scipy.

The reference's acceptance oracle is scipy at rtol=1e-5/atol=1e-8
(``/root/reference/tests/test_basic.py:54``).  This harness measures on the
GPU the max relative error against the f64 scipy product of

* the three policies of ``config.Precision`` through ``spgemm_dense_out``:
  AUTO (f64 operands), FAST (f32 operands, f32 product at 'highest') and
  SPLIT (hi/lo f32 split);
* float32 products under each candidate ``lax.DotAlgorithmPreset`` (TF32
  is what an f32 dot with no stated precision may get on the GPU).

Max relative error = max |got - ref| / (|ref| + 1e-8), the floor matching
the oracle's atol.  Exits non-zero without a GPU.

Usage::

    python benchmarks/accuracy.py [--json chiprun_out/accuracy.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import sparse_matrix_mult_tpu  # noqa: F401  (enables x64)
from sparse_matrix_mult_tpu.ops.convert import csr_to_dense
from sparse_matrix_mult_tpu.ops.dense_path import spgemm_dense_out
from sparse_matrix_mult_tpu.types import from_scipy

CONFIGS = [
    (500, 0.3),
    (2000, 0.05),
    (10_000, 0.1),
]
ORACLE_RTOL = 1e-5  # /root/reference/tests/test_basic.py:54
ATOL_FLOOR = 1e-8
_A = jax.lax.DotAlgorithmPreset
ALGORITHMS = {
    "tf32": _A.TF32_TF32_F32,
    "tf32x3": _A.TF32_TF32_F32_X3,
    "bf16x3": _A.BF16_BF16_F32_X3,
    "bf16x6": _A.BF16_BF16_F32_X6,
    "bf16x9": _A.BF16_BF16_F32_X9,
    "f32": _A.F32_F32_F32,
}


def max_rel(got, ref: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - ref) / (np.abs(ref) + ATOL_FLOOR)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"accuracy.py measures the GPU; JAX found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"# {smi}; {dev.device_kind} x{len(jax.devices())}; jax {jax.__version__}")

    rows = []
    for n, density in CONFIGS:
        A = sp.random(n, n, density=density, format="csr", random_state=1)
        B = sp.random(n, n, density=density, format="csr", random_state=2)
        ref = (A @ B).toarray()  # scipy f64 oracle
        a64, b64 = from_scipy(A), from_scipy(B)
        row = {"config": f"{n}x{n}_d{density}", "device_kind": dev.device_kind}
        for policy in ("auto", "fast", "split"):
            got = spgemm_dense_out(a64, b64, precision=policy)
            row[f"{policy}_max_rel"] = max_rel(got, ref)
        ad = csr_to_dense(a64, jnp.float32)
        bd = csr_to_dense(b64, jnp.float32)
        for name, alg in ALGORITHMS.items():
            f = jax.jit(lambda x, y, alg=alg: jnp.dot(x, y, precision=alg))
            try:
                row[f"dot_{name}_max_rel"] = max_rel(f(ad, bd), ref)
            except Exception as e:  # an algorithm this backend refuses
                row[f"dot_{name}_max_rel"] = f"refused: {type(e).__name__}"
        row["oracle_rtol"] = ORACLE_RTOL
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
