"""Run the library's main path once on a GPU and check every result.

    python chip_smoke.py          # one GPU: phases 0-5
    python chip_smoke.py --four   # four GPUs: the distributed layer only

Phase 0 prints the card (``nvidia-smi`` name and power limit), the JAX
device kind and count, the JAX version, the compile cache directory and
whether the native host library loaded.  Every later check prints its name,
shape, nnz, route, max abs and rel error against a float64 scipy or numpy
reference, the tolerance, and a warm time: the median of 3 runs after one
warm-up, each ending in ``block_until_ready``.  The times are information,
not records.

Each phase is a function of its sizes, so the tests call it at a tiny size
on the CPU.  ``main()`` refuses to run without a GPU.  It exits non-zero,
and prints no result line, when JAX finds no GPU or any check fails.  The
last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

import sparse_matrix_mult_tpu as smm
from sparse_matrix_mult_tpu.ops.spgemm_binned import binned_plan
from sparse_matrix_mult_tpu.ops.spgemm_jnp import expansion_size, windowed_plan
from sparse_matrix_mult_tpu.ops.triu_matmul import matmul_triu
from sparse_matrix_mult_tpu.utils.testing import hypersparse_random

# The reference's oracle (README.md:398, tests/test_basic.py:54).
RTOL, ATOL = 1e-5, 1e-8
REPS = 3


class Report:
    """Prints each check and collects the failures of one run."""

    def __init__(self):
        self.failures: list[str] = []

    def fail(self, what: str) -> None:
        print(f"FAIL {what}", flush=True)
        self.failures.append(what)

    def check(
        self, phase, name, got, ref, *, route="device", seconds=None,
        device_path=True, rtol=RTOL, atol=ATOL, why="", must_pass=True,
    ) -> bool:
        """Compare ``got`` with ``ref``; with ``device_path`` a ``host``
        route fails the check too."""
        abs_err, rel_err, ok = compare(got, ref, rtol, atol)
        nnz = got.nnz if sp.issparse(got) else int(np.count_nonzero(np.asarray(got)))
        t = "n/a" if seconds is None else f"{seconds:.6f}s"
        tol = f"rtol={rtol:g} atol={atol:g}" + (f" ({why})" if why else "")
        status = "ok" if ok else ("FAIL" if must_pass else "over tolerance")
        print(
            f"[{phase}] {name}: shape={tuple(got.shape)} nnz={nnz} route={route} "
            f"max_abs={abs_err:.3e} max_rel={rel_err:.3e} {tol} warm={t} {status}",
            flush=True,
        )
        if must_pass and not ok:
            self.failures.append(f"{phase}/{name}")
        if device_path and route == "host":
            self.fail(f"{phase}/{name}: routed to the host, not the device")
            ok = False
        return ok


def _max(x) -> float:
    return float(np.max(x)) if np.size(x) else 0.0


def compare(got, ref, rtol=RTOL, atol=ATOL):
    """(max abs error, max rel error over nonzero reference entries, whether
    every entry meets ``|got - ref| <= atol + rtol * |ref|``)."""
    if sp.issparse(got) or sp.issparse(ref):
        got = sp.csr_matrix(got, dtype=np.float64)
        ref = sp.csr_matrix(ref, dtype=np.float64)
        for m in (got, ref):
            m.sum_duplicates()
            m.sort_indices()
        if (
            got.nnz == ref.nnz
            and np.array_equal(got.indptr, ref.indptr)
            and np.array_equal(got.indices, ref.indices)
        ):
            g, r = got.data, ref.data
        else:  # differing structure: compare over the union of entries
            diff = abs(got - ref).tocsr()
            bound = abs(ref).multiply(rtol).tocsr()
            excess = (diff - bound).tocsr()
            ref_nz = ref.copy()
            ref_nz.eliminate_zeros()
            rel = diff.multiply(abs(ref_nz).power(-1))
            return _max(diff.data), _max(rel.data), _max(excess.data) <= atol
        err = np.abs(g - r)
        nz = r != 0
        rel = err[nz] / np.abs(r[nz])
        return _max(err), _max(rel), bool(np.all(err <= atol + rtol * np.abs(r)))
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    abs_err = rel_err = 0.0
    ok = True
    rows = max(1, (1 << 24) // max(ref.shape[-1], 1))  # bounded temporaries
    for r0 in range(0, max(ref.shape[0], 1), rows):
        g = got[r0 : r0 + rows].astype(np.float64)
        r = ref[r0 : r0 + rows].astype(np.float64)
        err = np.abs(g - r)
        nz = r != 0
        abs_err = max(abs_err, _max(err))
        rel_err = max(rel_err, _max(err[nz] / np.abs(r[nz])))
        ok = ok and bool(np.all(err <= atol + rtol * np.abs(r)))
    return abs_err, rel_err, ok


def _sync(x):
    if not (isinstance(x, np.ndarray) or sp.issparse(x)):
        jax.block_until_ready(x)
    return x


def timed(fn, reps: int = REPS):
    """(result, median warm seconds): one warm-up call, then ``reps`` runs
    each ending in ``block_until_ready``."""
    _sync(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _sync(fn())
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def _host_ref(label: str, fn):
    t0 = time.perf_counter()
    out = fn()
    print(f"  reference {label}: {time.perf_counter() - t0:.2f}s on the host", flush=True)
    return out


def phase_env(report: Report) -> None:
    """Phase 0: what the run is on."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"not available ({e})"
    from sparse_matrix_mult_tpu.utils.native import get_native

    dev = jax.devices()[0]
    print("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    print(smi)
    print(f"device: platform={dev.platform} kind={dev.device_kind} count={len(jax.devices())}")
    print(f"jax {jax.__version__}")
    print(f"compile cache dir: {jax.config.jax_compilation_cache_dir}")
    print(f"native host library loaded: {get_native() is not None}", flush=True)


def phase_headline(report: Report, n: int = 10_000, density: float = 0.1) -> None:
    """Phase 1: the reference's headline product, four ways."""
    a = sp.random(n, n, density=density, format="csr", random_state=1)
    b = sp.random(n, n, density=density, format="csr", random_state=2)
    ref = _host_ref("scipy A @ B", lambda: (a @ b).tocsr())
    ref.sort_indices()
    ref_dense = ref.toarray()
    cases = [
        ("sparse", {}, ref),
        ("sparse_symmetric", {"symmetric": True}, sp.triu(ref, format="csr")),
        ("dense", {"output_format": "dense"}, ref_dense),
        ("dense_symmetric", {"output_format": "dense", "symmetric": True}, np.triu(ref_dense)),
    ]
    print(f"[1 headline] A, B: {n}x{n} d={density} nnz(A)={a.nnz} nnz(B)={b.nnz}")
    for name, kw, want in cases:
        got, t = timed(lambda: smm.sparse_matrix_multiply(a, b, **kw))
        report.check("1 headline", name, got, want, route=smm.get_last_route(), seconds=t)


def phase_dense_output(report: Report, n: int = 10_000, density: float = 0.001) -> None:
    """Phase 2: sparse x sparse -> dense through both entry points."""
    a = sp.random(n, n, density=density, format="csr", random_state=3)
    b = sp.random(n, n, density=density, format="csr", random_state=4)
    ref = _host_ref("scipy A @ B", lambda: (a @ b).toarray())
    print(f"[2 dense] A, B: {n}x{n} d={density} nnz(A)={a.nnz} nnz(B)={b.nnz}")
    got, t = timed(lambda: smm.sparse_matrix_multiply(a, b, output_format="dense"))
    # The scipy entry point may route this size to the host by its cost model.
    report.check("2 dense", "sparse_matrix_multiply", got, ref,
                 route=smm.get_last_route(), seconds=t, device_path=False)
    ad, bd = smm.from_scipy(a), smm.from_scipy(b)
    fn = jax.jit(lambda x, y: smm.multiply(x, y, output_format="dense"))
    got, t = timed(lambda: fn(ad, bd))
    report.check("2 dense", "multiply", got, ref, seconds=t)


def phase_triple(report: Report, m: int = 20_000, n: int = 10_000, density: float = 3e-3) -> None:
    """Phase 3: the fused triple product H . Q . H^T."""
    h = hypersparse_random(m, n, int(m * n * density), seed=5)
    q = hypersparse_random(n, n, int(n * n * density), seed=6)
    hd = h.toarray()
    c = _host_ref("numpy H @ Q @ H.T", lambda: (hd @ q.toarray()) @ hd.T)
    del hd
    upper = np.triu(c)
    full = upper + np.triu(c, 1).T
    del c
    print(f"[3 triple] H: {m}x{n} nnz={h.nnz}; Q: {n}x{n} nnz={q.nnz}")
    for cfm, want in ((0, upper), (1, full)):
        got, t = timed(lambda: smm.sparse_matrix_multiply(
            h, q, use_triple_product=True, compute_full_matrix=cfm))
        report.check("3 triple", f"compute_full_matrix={cfm}", got, want,
                     route=smm.get_last_route(), seconds=t)
    hq, qq = smm.from_scipy(h), smm.from_scipy(q)
    fn = jax.jit(lambda x, y: smm.triple_product(x, y, 0))
    got, t = timed(lambda: fn(hq, qq))
    report.check("3 triple", "triple_product", got, upper, seconds=t)


def phase_esc(
    report: Report,
    n: int = 100_000,
    nnz: int = 1_000_000,
    big_n: int = 1_000_000,
    big_nnz: int = 10_000_000,
) -> None:
    """Phase 4: the three ESC engines through ``multiply``, then the large
    product through ``sparse_matrix_multiply``."""
    cfg = smm.get_config()
    a = hypersparse_random(n, n, nnz, seed=7)
    b = hypersparse_random(n, n, nnz, seed=8)
    ref = _host_ref("scipy A @ B", lambda: (a @ b).tocsr())
    expand = expansion_size(a.indices, a.nnz, b.indptr)
    print(f"[4 esc] A, B: {n}x{n} nnz(A)={a.nnz} nnz(B)={b.nnz} partial products={expand}")
    ad, bd = smm.from_scipy(a), smm.from_scipy(b)
    out_cap = smm.bucket_capacity(min(expand, n * n))
    exp_cap = smm.bucket_capacity(expand)
    engines = {}
    plan = binned_plan(a.indptr, a.indices, b.indptr,
                       window=cfg.binned_window, lane_width=cfg.binned_lane_width)
    if plan is None:
        report.fail("4 esc/binned: binned_plan found no layout")
    else:
        engines["binned"] = dict(plan=plan)
    wplan = windowed_plan(a.nnz, np.diff(b.indptr)[a.indices], expand)
    if wplan is None:
        report.fail("4 esc/windowed: windowed_plan found no window")
    else:
        w, tail = wplan
        engines["windowed"] = dict(
            window=w, expand_capacity=exp_cap,
            tail_capacity=smm.bucket_capacity(tail) if tail else 0,
        )
    engines["classic"] = dict(expand_capacity=exp_cap)
    for name, kw in engines.items():
        c, t = timed(lambda: smm.multiply(ad, bd, out_capacity=out_cap, **kw))
        report.check("4 esc", name, smm.to_scipy(c), ref, seconds=t)

    a1 = hypersparse_random(big_n, big_n, big_nnz, seed=9)
    b1 = hypersparse_random(big_n, big_n, big_nnz, seed=10)
    ref1 = _host_ref("scipy A @ B", lambda: (a1 @ b1).tocsr())
    print(f"[4 esc] A, B: {big_n}x{big_n} nnz(A)={a1.nnz} nnz(B)={b1.nnz} "
          f"partial products={expansion_size(a1.indices, a1.nnz, b1.indptr)}")
    got, t = timed(lambda: smm.sparse_matrix_multiply(a1, b1))
    from sparse_matrix_mult_tpu.api import get_last_route_detail

    route = smm.get_last_route()
    chunks = get_last_route_detail().get("chunks")
    report.check("4 esc", f"sparse_matrix_multiply {big_n}^2 (chunks={chunks})",
                 got, ref1, route=route, seconds=t)


def _triu_candidates():
    """(name, dtype, function) of every triangular-product candidate built
    here.  ``plain`` is the one the library uses; ``full`` is the whole
    product masked afterwards, and ``plain_tf32x3`` the same recursion
    under the TF32x3 dot algorithm, both for comparison."""
    highest = jax.lax.Precision.HIGHEST
    cands = [
        ("plain", np.float64, lambda x, y: matmul_triu(x, y)),
        ("full", np.float64, lambda x, y: jnp.triu(jnp.dot(x, y, precision=highest))),
        ("plain", np.float32, lambda x, y: matmul_triu(x, y)),
        ("full", np.float32, lambda x, y: jnp.triu(jnp.dot(x, y, precision=highest))),
    ]
    if jax.devices()[0].platform == "gpu":  # TF32 algorithms exist only there
        x3 = jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3
        cands.append(("plain_tf32x3", np.float32,
                      lambda x, y: matmul_triu(x, y, precision=x3)))
    return cands


def phase_triu(report: Report, n: int = 10_000, density: float = 0.1) -> None:
    """Phase 5: the upper-triangular product in float32 and float64."""
    a = sp.random(n, n, density=density, format="csr", random_state=1).toarray()
    b = sp.random(n, n, density=density, format="csr", random_state=2).toarray()
    ref = _host_ref("numpy triu(A @ B)", lambda: np.triu(a @ b))
    print(f"[5 triu] A, B: dense {n}x{n} from d={density}")
    for name, dtype, fn in _triu_candidates():
        x, y = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
        f = jax.jit(fn)
        got, t = timed(lambda: f(x, y))
        report.check("5 triu", f"{name} {np.dtype(dtype).name}", got, ref, seconds=t,
                     must_pass=(name == "plain"),
                     why="float32 operands" if dtype == np.float32 else "")
        del x, y, got
    print("[5 triu] stays: plain (2x2 block recursion of XLA dots)", flush=True)


def _check_shards(report: Report, what: str, arrays, devices) -> None:
    want = set(devices)
    for i, arr in enumerate(arrays):
        shards = arr.addressable_shards
        got = {s.device for s in shards}
        if len(shards) != len(want) or got != want:
            report.fail(f"{what}[{i}]: {len(shards)} shards on {sorted(map(str, got))}")
    print(f"  {what}: one shard on each of {len(want)} devices", flush=True)


def _csr_arrays(x):
    return (x.indptrs, x.indices, x.values)


def phase_four(
    report: Report,
    devices,
    n: int = 10_000,
    density: float = 0.1,
    big_n: int = 1_000_000,
    big_nnz: int = 10_000_000,
    tri_m: int = 20_000,
    tri_n: int = 10_000,
    tri_density: float = 3e-3,
) -> None:
    """The distributed layer on a 1D ``row_mesh`` over ``devices``."""
    from sparse_matrix_mult_tpu.parallel.distributed import (
        shard_csr,
        spgemm_csr_distributed,
        spgemm_csr_distributed_sparse,
        triple_product_distributed_sparse,
    )
    from sparse_matrix_mult_tpu.parallel.mesh import row_mesh

    mesh = row_mesh(devices)
    k = len(devices)

    a = sp.random(n, n, density=density, format="csr", random_state=1)
    b = sp.random(n, n, density=density, format="csr", random_state=2)
    ref = _host_ref("scipy A @ B", lambda: (a @ b).tocsr())
    ad, bd = shard_csr(a, mesh), shard_csr(b, mesh)
    _check_shards(report, "dense-ring operands", _csr_arrays(ad) + _csr_arrays(bd), devices)
    got, t = timed(lambda: spgemm_csr_distributed(ad, bd, mesh=mesh))
    _check_shards(report, "dense-ring result", _csr_arrays(got), devices)
    report.check(f"four x{k}", f"spgemm_csr_distributed {n}^2 d={density}",
                 got.to_scipy(), ref, seconds=t)
    del ref, got

    a1 = hypersparse_random(big_n, big_n, big_nnz, seed=9)
    b1 = hypersparse_random(big_n, big_n, big_nnz, seed=10)
    ref1 = _host_ref("scipy A @ B", lambda: (a1 @ b1).tocsr())
    b1d = shard_csr(b1, mesh)
    _check_shards(report, "sparse-ring operand B", _csr_arrays(b1d), devices)
    got, t = timed(lambda: spgemm_csr_distributed_sparse(a1, b1d, mesh=mesh))
    _check_shards(report, "sparse-ring result", _csr_arrays(got), devices)
    report.check(f"four x{k}", f"spgemm_csr_distributed_sparse {big_n}^2",
                 got.to_scipy(), ref1, seconds=t)
    del ref1, got

    h = hypersparse_random(tri_m, tri_n, int(tri_m * tri_n * tri_density), seed=5)
    q = hypersparse_random(tri_n, tri_n, int(tri_n * tri_n * tri_density), seed=6)
    hd = h.toarray()
    upper = np.triu(_host_ref("numpy H @ Q @ H.T", lambda: (hd @ q.toarray()) @ hd.T))
    del hd
    qd = shard_csr(q, mesh)
    _check_shards(report, "triple operand Q", _csr_arrays(qd), devices)
    got, t = timed(lambda: triple_product_distributed_sparse(h, qd, 0, mesh=mesh))
    _check_shards(report, "triple result", [got], devices)
    report.check(f"four x{k}", f"triple_product_distributed_sparse {tri_m}x{tri_n}",
                 got, upper, seconds=t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed layer, on four GPUs")
    args = ap.parse_args(argv)

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}", file=sys.stderr)
        return 2

    report = Report()
    phase_env(report)
    if args.four:
        phase_four(report, devices[:4])
    else:
        phase_headline(report)
        phase_dense_output(report)
        phase_triple(report)
        phase_esc(report)
        phase_triu(report)
    if report.failures:
        print(f"chip_smoke: {len(report.failures)} check(s) failed: {report.failures}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
