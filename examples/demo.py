"""End-to-end demo of all five routines, with numpy comparisons.

Parity with the reference's demo script
(``/root/reference/sparse_matrix_mult/matrix_ops_test_script.py``): the same
five calls on small matrices, printing framework-vs-numpy results, plus a
taste of the device-native API the reference has no analogue for.

Run:  python examples/demo.py
"""

import numpy as np
import scipy.sparse as sp

import sparse_matrix_mult_tpu as smm

np.set_printoptions(precision=3, suppress=True)


def check(name, got, expected):
    ok = np.allclose(got, expected, rtol=1e-5, atol=1e-8)
    print(f"[{'ok' if ok else 'FAIL'}] {name}")
    if not ok:
        print("  got:\n", got, "\n  expected:\n", expected)


def main():
    rng = np.random.default_rng(7)
    a = sp.random(3, 4, density=0.6, format="csr", random_state=1)
    b = sp.random(4, 4, density=0.6, format="csr", random_state=2)
    c = sp.random(4, 3, density=0.6, format="csr", random_state=3)

    print("A =\n", a.toarray())
    print("B =\n", b.toarray())

    # 1. sparse x sparse -> sparse CSR
    r1 = smm.sparse_matrix_multiply(a, b, output_format="sparse")
    check("sparse x sparse -> sparse", r1.toarray(), (a @ b).toarray())

    # 2. sparse x sparse -> dense
    r2 = smm.sparse_matrix_multiply(a, b, output_format="dense")
    check("sparse x sparse -> dense", r2, (a @ b).toarray())

    # 3. symmetric sparse (upper triangle only); needs a square product
    sq = sp.random(4, 4, density=0.6, format="csr", random_state=4)
    r3 = smm.sparse_matrix_multiply(sq, b, output_format="sparse", symmetric=True)
    check("symmetric sparse (triu)", r3.toarray(), np.triu((sq @ b).toarray()))

    # 4. symmetric dense
    r4 = smm.sparse_matrix_multiply(sq, b, output_format="dense", symmetric=True)
    check("symmetric dense (triu)", r4, np.triu((sq @ b).toarray()))

    # 5. fused triple product H.Q.H^T
    h = sp.random(3, 4, density=0.7, format="csr", random_state=5)
    q = sp.random(4, 4, density=0.7, format="csr", random_state=6)
    ref = (h @ q @ h.T).toarray()
    r5 = smm.sparse_matrix_multiply(h, q, use_triple_product=True)
    check("triple product (triu)", r5, np.triu(ref))
    r5f = smm.sparse_matrix_multiply(h, q, use_triple_product=True, compute_full_matrix=1)
    check("triple product (full)", r5f, np.triu(ref) + np.triu(ref, 1).T)

    # Device-native API: stays on device, composes under jit.
    import jax

    ad = smm.from_scipy(a)
    bd = smm.from_scipy(b)
    dense_fn = jax.jit(lambda x, y: smm.multiply(x, y, output_format="dense"))
    check("device-native jit multiply", np.asarray(dense_fn(ad, bd)), (a @ b).toarray())

    # Distributed: row-sharded operands over a device mesh (the reference's
    # per-thread row ranges, scaled to chips); densify-per-shard + B ring.
    if len(jax.devices()) > 1:
        from sparse_matrix_mult_tpu.parallel.distributed import (
            shard_csr,
            spgemm_csr_distributed,
        )
        from sparse_matrix_mult_tpu.parallel.mesh import row_mesh

        mesh = row_mesh()
        big_a = sp.random(64, 48, density=0.2, format="csr", random_state=8)
        big_b = sp.random(48, 56, density=0.2, format="csr", random_state=9)
        sh = spgemm_csr_distributed(
            shard_csr(big_a, mesh), shard_csr(big_b, mesh), mesh=mesh
        )
        check(
            f"distributed CSR product over {mesh.devices.size} devices",
            sh.to_scipy().toarray(),
            (big_a @ big_b).toarray(),
        )

        # Large-sparse engine: identical result, but nothing is ever
        # densified -- B blocks ring-rotate as packed CSR (the engine for
        # matrices whose dense shard panels would not fit device memory).
        from sparse_matrix_mult_tpu.parallel.distributed import (
            spgemm_csr_distributed_sparse,
        )

        sh2 = spgemm_csr_distributed_sparse(big_a, big_b, mesh=mesh)
        check(
            "distributed sparse-local-contraction product",
            sh2.to_scipy().toarray(),
            (big_a @ big_b).toarray(),
        )

        # Sparse distributed triple product: H.Q.H^T with neither operand
        # ever densified (two sparse rings; dense output panel only).
        from sparse_matrix_mult_tpu.parallel.distributed import (
            triple_product_distributed_sparse,
        )

        hh = sp.random(16, 48, density=0.2, format="csr", random_state=12)
        qq = sp.random(48, 48, density=0.2, format="csr", random_state=13)
        check(
            "distributed sparse triple product",
            np.asarray(triple_product_distributed_sparse(hh, qq, 1, mesh=mesh)),
            (hh @ qq @ hh.T).toarray(),
        )

    # Linear-inversion model: the reference's motivating workload, assembled.
    from sparse_matrix_mult_tpu.models.inversion import invert

    n_obs, n_state = 6, 20
    H = sp.random(n_obs, n_state, density=0.4, format="csr", random_state=10)
    A = sp.random(n_state, n_state, density=0.2, format="csr", random_state=11)
    Q = (A @ A.T + sp.eye(n_state)).tocsr()
    y = rng.standard_normal(n_obs)
    x0 = np.zeros(n_state)
    r_diag = np.full(n_obs, 0.5)
    res = invert(smm.from_scipy(H), smm.from_scipy(Q), y, x0, r_diag)
    print(
        "[ok] inversion step: posterior mean norm "
        f"{float(np.linalg.norm(np.asarray(res.x_post))):.3f}, "
        f"min marginal variance {float(np.min(np.asarray(res.p_diag))):.3f}"
    )

    print("demo complete on backend:", jax.default_backend())


if __name__ == "__main__":
    main()
