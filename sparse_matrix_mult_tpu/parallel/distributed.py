"""Multi-chip SpGEMM: row-sharded CSR operands, ring-rotated B blocks between devices.

The reference's only parallelism is OpenMP threads over contiguous row ranges
in one address space, with B held once in shared memory and read by every
thread (``/root/reference/src/workdivision.cpp:16-89``,
``sparse_sparse_sparse.cpp:228-241``).  The scale-out dimension here is
a 1D device mesh:

* **A and C are row-sharded** (:class:`ShardedCSR`) -- each chip owns a
  contiguous block of output rows, the direct analogue of the reference's
  per-thread row ranges.  Shard boundaries may be flop-balanced
  (:func:`flop_shard_bounds`), the distributed counterpart of the
  reference's ``schedule(dynamic)`` rebalancing.
* **B is row-sharded along the contraction dimension** and *ring-rotated*:
  at step ``s`` chip ``d`` holds B row-block ``(d + s) mod S``, contracts it
  against the matching column slice of its local A rows, accumulates into
  its local C rows, and forwards the block to its neighbour via
  ``lax.ppermute``.  After ``S`` steps every chip has seen every B block
  while only ever storing ``1/S`` of B; XLA overlaps the permute with the
  dense contraction.
* **Densification happens per shard, inside ``shard_map``** -- no chip ever
  materializes a full dense A or B, so problems larger than one device's memory
  scale with the mesh.  (Round 1 densified globally before sharding; fixed
  per the round-1 review.)

Ingestion: :func:`shard_csr` splits a host CSR matrix into per-device row
blocks and places them with ``jax.make_array_from_callback`` (multi-host
compatible: each process materializes only its addressable shards).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.convert import csr_to_dense, dense_to_csr
from ..types import CSRMatrix, INDEX_DTYPE, bucket_capacity, row_ids_from_indptr
from .mesh import row_mesh

__all__ = [
    "ShardedCSR",
    "shard_csr",
    "flop_shard_bounds",
    "ring_matmul",
    "spgemm_dense_distributed",
    "spgemm_csr_distributed",
    "spgemm_csr_distributed_sparse",
    "triple_product_distributed",
    "triple_product_distributed_sparse",
    "pad_to_multiple",
]


def _device_varying(x, axis):
    """Mark a replicated-looking value as device-varying inside shard_map."""
    return lax.pcast(x, (axis,), to="varying")


def pad_to_multiple(x: jax.Array, axis: int, multiple: int) -> jax.Array:
    """Zero-pad ``x`` along ``axis`` up to the next multiple (static)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return jnp.pad(x, widths)


# ---------------------------------------------------------------------------
# Row-sharded CSR container (input AND output).
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Row-sharded CSR matrix: per-shard packed CSR blocks on device.

    The multi-chip analogue of the reference orchestrators' per-thread row
    ranges (``/root/reference/src/sparse_sparse_sparse.cpp:90-128``): shard
    ``s`` holds global rows ``bounds[s]:bounds[s+1]`` as a local packed CSR
    (row pointers rebased to 0).  Used both for *operands* (built by
    :func:`shard_csr`) and for *results* (built on device by
    :func:`spgemm_csr_distributed`); ``to_scipy`` stitches the shards on
    host via the native C++ runtime.

    * ``indptrs``  -- (S, rows_pad + 1) int32; rows past a shard's logical
      row count repeat the last pointer (empty padding rows).
    * ``indices``/``values`` -- (S, shard_capacity), padded.
    * ``shape``    -- logical global shape (static).
    * ``bounds``   -- global row boundaries, length S+1 (static); ``None``
      means uniform ``ceil(m / S)`` blocks.
    """

    indptrs: jax.Array
    indices: jax.Array
    values: jax.Array
    shape: tuple
    bounds: tuple | None = None

    def tree_flatten(self):
        return (self.indptrs, self.indices, self.values), (self.shape, self.bounds)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, shape=aux[0], bounds=aux[1])

    @property
    def n_shards(self) -> int:
        return int(self.indptrs.shape[0])

    @property
    def rows_pad(self) -> int:
        return int(self.indptrs.shape[1]) - 1

    @property
    def shard_capacity(self) -> int:
        return int(self.indices.shape[1])

    @property
    def row_bounds(self) -> tuple:
        if self.bounds is not None:
            return self.bounds
        m = self.shape[0]
        per = self.rows_pad
        return tuple(min(i * per, m) for i in range(self.n_shards + 1))

    def to_scipy(self):
        """Gather the shards and stitch into one scipy CSR on host."""
        import scipy.sparse as sp

        from ..utils.native import stitch_csr

        m, ncols = self.shape
        bounds = self.row_bounds
        # One bulk transfer per array; all trimming on host (device-side
        # data-dependent slices would recompile per distinct nnz).
        indptrs = np.asarray(self.indptrs)
        indices = np.asarray(self.indices)
        values = np.asarray(self.values)
        chunks = []
        for s in range(self.n_shards):
            rows_here = bounds[s + 1] - bounds[s]
            ip = indptrs[s][: rows_here + 1]
            nnz = int(ip[-1]) if rows_here else 0
            chunks.append(
                sp.csr_matrix(
                    (values[s][:nnz], indices[s][:nnz], ip),
                    shape=(rows_here, ncols),
                )
            )
        return stitch_csr(chunks, m, ncols)


def _uniform_bounds(m: int, s: int) -> tuple:
    per = -(-m // s) if m else 1
    return tuple(min(i * per, m) for i in range(s + 1))


def _pad_bounds(bounds, m: int, s: int) -> tuple:
    """Pad flop-balanced bounds to exactly ``s + 1`` entries.

    ``flop_balanced_partition`` returns ``min(parts, rows) + 1`` boundaries;
    with fewer rows than mesh devices the trailing shards must exist (empty)
    or ``shard_csr`` rejects the bounds with an opaque error."""
    bounds = tuple(int(b) for b in bounds)
    if len(bounds) < s + 1:
        bounds = bounds + (m,) * (s + 1 - len(bounds))
    return bounds


def _as_scipy(mat):
    import scipy.sparse as sp

    if isinstance(mat, ShardedCSR):
        return mat.to_scipy()
    if isinstance(mat, CSRMatrix):
        from ..types import to_scipy as _to

        return _to(mat)
    if not sp.issparse(mat):
        return sp.csr_matrix(np.asarray(mat))
    return mat.tocsr()


def shard_csr(
    mat,
    mesh: Optional[Mesh] = None,
    *,
    bounds=None,
    dtype=None,
    capacity: int | None = None,
) -> ShardedCSR:
    """Split a host CSR matrix into per-device row blocks and place them.

    Each device receives only its own block's ``indptr/indices/values``
    (via ``jax.make_array_from_callback``, so multi-host processes
    materialize just their addressable shards).  ``bounds`` defaults to
    uniform ``ceil(m/S)`` blocks; pass :func:`flop_shard_bounds` output for
    flop-balanced blocks on skewed matrices.
    """
    mesh = mesh or row_mesh()
    (axis,) = mesh.axis_names
    s_count = mesh.devices.size
    mat = _as_scipy(mat)
    m, n = (int(x) for x in mat.shape)
    if bounds is None:
        bounds = _uniform_bounds(m, s_count)
    bounds = tuple(int(b) for b in bounds)
    if len(bounds) != s_count + 1 or bounds[0] != 0 or bounds[-1] != m:
        raise ValueError(f"bounds {bounds} invalid for {m} rows / {s_count} shards")
    rows_pad = max(
        max(b1 - b0 for b0, b1 in zip(bounds[:-1], bounds[1:])), 1
    )
    shard_nnz = [
        int(mat.indptr[b1] - mat.indptr[b0])
        for b0, b1 in zip(bounds[:-1], bounds[1:])
    ]
    cap = int(capacity) if capacity is not None else bucket_capacity(max(shard_nnz + [1]))
    if cap < max(shard_nnz):
        raise ValueError(f"capacity {cap} < max shard nnz {max(shard_nnz)}")
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    # Shards are materialized LAZILY inside the placement callback: on a
    # multi-host pod each process builds only the padded blocks backing its
    # own addressable devices (jax only invokes the callback for those), so
    # no process ever holds the full (S, cap) arrays host-side.  The source
    # scipy arrays are only sliced at [indptr[b0]:indptr[b1]) per owned
    # shard.  Same pattern as io.load_sharded_operand's per-shard file
    # reads.
    cache: dict = {}

    def _shard_arrays(s: int):
        if s not in cache:
            _note_materialized(s)
            b0, b1 = bounds[s], bounds[s + 1]
            lo, hi = int(mat.indptr[b0]), int(mat.indptr[b1])
            ip = np.zeros(rows_pad + 1, np.int32)
            ip[1 : b1 - b0 + 1] = mat.indptr[b0 + 1 : b1 + 1] - lo
            ip[b1 - b0 + 1 :] = hi - lo
            ix = np.zeros(cap, np.int32)
            ix[: hi - lo] = mat.indices[lo:hi]
            vv = np.zeros(cap, np.dtype(dtype))
            vv[: hi - lo] = mat.data[lo:hi]
            cache[s] = (ip, ix, vv)
        return cache[s]

    def put(kind: int, shape, np_dtype):
        sh = NamedSharding(mesh, P(axis, *([None] * (len(shape) - 1))))

        def cb(idx):
            s = idx[0].start or 0
            return _shard_arrays(s)[kind][None]

        return jax.make_array_from_callback(shape, sh, cb)

    ip = put(0, (s_count, rows_pad + 1), np.int32)
    ix = put(1, (s_count, cap), np.int32)
    vv = put(2, (s_count, cap), np.dtype(dtype))
    cache.clear()
    return ShardedCSR(ip, ix, vv, (m, n), bounds)


# Instrumentation for the per-process data-locality contract: with
# TRACK_MATERIALIZATION on, every shard index a shard_csr placement
# callback materializes on THIS process is appended (tests flip the flag
# and assert a process touches only its own shards).  Off by default so
# long-lived pipelines never accumulate unbounded state.
TRACK_MATERIALIZATION: bool = False
MATERIALIZED_SHARDS: list = []


def _note_materialized(s: int) -> None:
    if TRACK_MATERIALIZATION:
        MATERIALIZED_SHARDS.append(int(s))


def flop_shard_bounds(a_sp, b_sp, n_shards: int) -> tuple:
    """Flop-balanced shard boundaries for ``A @ B`` (host-side).

    Balances the per-shard count of partial products -- the quantity the
    reference's ``schedule(dynamic)`` clauses rebalance at runtime
    (``/root/reference/src/sparse_sparse_sparse.cpp:233``) -- instead of raw
    row counts (its static ``limits`` partitioner, ``workdivision.cpp:45-86``).
    """
    from .partition import flop_balanced_partition, row_flops

    a_sp = _as_scipy(a_sp)
    if isinstance(b_sp, ShardedCSR):
        b_indptr = _sharded_global_indptr(b_sp)
    else:
        b_indptr = _as_scipy(b_sp).indptr
    flops = row_flops(a_sp.indptr, a_sp.indices, b_indptr)
    return _pad_bounds(
        flop_balanced_partition(flops, n_shards), a_sp.shape[0], n_shards
    )


# ---------------------------------------------------------------------------
# Ring SpGEMM over sharded operands.
# ---------------------------------------------------------------------------


def _local_dense(ip, ix, vv, rows: int, cols: int, dtype=None):
    """Densify one shard's packed CSR block inside a shard_map body."""
    csr = CSRMatrix(
        indptr=ip.reshape(-1)[: rows + 1],
        indices=ix.reshape(-1),
        values=vv.reshape(-1),
        shape=(rows, cols),
    )
    return csr_to_dense(csr, dtype=dtype)


def _ring_accumulate(a_pad, b_loc, axis: str, s_count: int, kb: int, out_dtype,
                     comm: bool = True):
    """Core BIDIRECTIONAL ring: rotate ``b_loc`` (one B row-block) around
    the mesh in both directions while contracting it with the matching A
    column slice.  ``a_pad`` is the local dense A rows with columns
    zero-padded to ``s_count * kb``.

    The ring runs both link directions at
    once.  Chip ``d`` contracts blocks ``d, d+1, ...`` from the clockwise
    stream and ``d-1, d-2, ...`` from the counter-clockwise stream --
    ``ceil(S/2)`` loop steps instead of ``S``, and each link direction
    carries only ~``S/2`` blocks total, halving both the latency-bound
    step count and the per-direction link bytes.

    Overlap structure: the permutes that fetch step ``t+1``'s blocks are
    issued BEFORE the dense contractions of step ``t`` and their results
    are consumed only at the next loop iteration -- no data dependence,
    so XLA's async-collective pass can run the link transfers under the
    compute (the standard ring-matmul latency-hiding form).
    """
    my = lax.axis_index(axis)
    rows_loc = a_pad.shape[0]

    def dot_blk(j, b_blk, acc, scale=None):
        zero = jnp.zeros((), jnp.int32)
        a_blk = lax.dynamic_slice(a_pad, (zero, j * kb), (rows_loc, kb))
        if scale is not None:
            a_blk = a_blk * scale
        return acc + jnp.dot(
            a_blk, b_blk, precision="highest", preferred_element_type=acc.dtype
        )

    acc0 = jnp.zeros((rows_loc, b_loc.shape[1]), dtype=out_dtype)
    acc0 = _device_varying(acc0, axis)
    if s_count == 1:
        return dot_blk(jnp.zeros((), jnp.int32), b_loc, acc0)

    perm_cw = [(i, (i - 1) % s_count) for i in range(s_count)]
    perm_ccw = [(i, (i + 1) % s_count) for i in range(s_count)]
    half = (s_count + 1) // 2  # cw steps; ccw runs s_count // 2 steps
    ccw_steps = s_count // 2

    def permute(x, perm):
        # comm=False: identity twin for the weak-scaling breakdown artifact
        # (same FLOPs/slices per shard, no link traffic) -- see
        # benchmarks/scaling.py --mode breakdown.
        return lax.ppermute(x, axis, perm) if comm else x

    def body(t, carry):
        b_cw, b_ccw, acc = carry
        b_cw_n = permute(b_cw, perm_cw)
        b_ccw_n = permute(b_ccw, perm_ccw)
        j1 = ((my + t) % s_count).astype(jnp.int32)
        acc = dot_blk(j1, b_cw, acc)
        j2 = ((my - t - 1) % s_count).astype(jnp.int32)
        # Odd S: the last iteration has no ccw block left; gate by zeroing
        # the A slice (one wasted block-dot on that final step only).
        gate = (t < ccw_steps).astype(a_pad.dtype)
        acc = dot_blk(j2, b_ccw, acc, scale=gate)
        return (b_cw_n, b_ccw_n, acc)

    b_ccw0 = permute(b_loc, perm_ccw)
    (_, _, out) = lax.fori_loop(0, half, body, (b_loc, b_ccw0, acc0))
    return out


def _check_operands(a: ShardedCSR, b: ShardedCSR):
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if a.n_shards != b.n_shards:
        raise ValueError("operands sharded over different mesh sizes")
    if b.bounds is not None and b.bounds != _uniform_bounds(b.shape[0], b.n_shards):
        raise ValueError("B must be uniformly row-sharded along the contraction dim")


def _shard(mat, mesh, bounds=None) -> ShardedCSR:
    return mat if isinstance(mat, ShardedCSR) else shard_csr(mat, mesh, bounds=bounds)


@functools.lru_cache(maxsize=None)
def _spgemm_dense_jit(mesh: Mesh, symmetric: bool, comm: bool = True):
    (axis,) = mesh.axis_names
    s_count = mesh.devices.size

    @jax.jit
    def fn(a: ShardedCSR, b: ShardedCSR):
        m, k = a.shape
        n = b.shape[1]
        kb = b.rows_pad
        rows_pad = a.rows_pad
        out_dtype = jnp.result_type(a.values.dtype, b.values.dtype)

        def local(a_ip, a_ix, a_v, b_ip, b_ix, b_v):
            a_loc = _local_dense(a_ip, a_ix, a_v, rows_pad, k)
            a_pad = pad_to_multiple(a_loc, 1, s_count * kb) if k < s_count * kb else a_loc
            b_loc = _local_dense(b_ip, b_ix, b_v, kb, n)
            return _ring_accumulate(a_pad, b_loc, axis, s_count, kb, out_dtype, comm=comm)

        sm = shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None),) * 6,
            out_specs=P(axis, None),
        )
        c = sm(a.indptrs, a.indices, a.values, b.indptrs, b.indices, b.values)
        c = c[:m]
        if symmetric:
            c = jnp.triu(c)
        return c

    return fn


def spgemm_dense_distributed(
    a,
    b,
    symmetric: bool = False,
    mesh: Optional[Mesh] = None,
):
    """sparse x sparse -> dense across the whole mesh (row-sharded output).

    Accepts :class:`ShardedCSR` operands (preferred: already placed), or any
    host CSR, which is sharded uniformly on ingest.  A must be row-sharded
    uniformly for this dense-output entry point (the global trim needs
    contiguous logical rows); use :func:`spgemm_csr_distributed` for
    flop-balanced bounds.
    """
    mesh = mesh or row_mesh()
    a = _shard(a, mesh)
    b = _shard(b, mesh)
    _check_operands(a, b)
    if a.bounds is not None and a.bounds != _uniform_bounds(a.shape[0], a.n_shards):
        raise ValueError("dense output requires uniformly row-sharded A")
    return _spgemm_dense_jit(mesh, symmetric)(a, b)


@functools.lru_cache(maxsize=None)
def _spgemm_csr_jit(mesh: Mesh, symmetric: bool, cap_l: int):
    (axis,) = mesh.axis_names
    s_count = mesh.devices.size

    @jax.jit
    def fn(a: ShardedCSR, b: ShardedCSR):
        m, k = a.shape
        n = b.shape[1]
        kb = b.rows_pad
        rows_pad = a.rows_pad
        bounds_arr = jnp.asarray(a.row_bounds, INDEX_DTYPE)
        out_dtype = jnp.result_type(a.values.dtype, b.values.dtype)

        def local(a_ip, a_ix, a_v, b_ip, b_ix, b_v):
            a_loc = _local_dense(a_ip, a_ix, a_v, rows_pad, k)
            a_pad = pad_to_multiple(a_loc, 1, s_count * kb) if k < s_count * kb else a_loc
            b_loc = _local_dense(b_ip, b_ix, b_v, kb, n)
            c_loc = _ring_accumulate(a_pad, b_loc, axis, s_count, kb, out_dtype)
            if symmetric:
                # Upper triangle in GLOBAL coordinates: local row r is
                # global row bounds[my] + r.
                my = lax.axis_index(axis)
                row0 = bounds_arr[my]
                gr = row0 + lax.broadcasted_iota(INDEX_DTYPE, c_loc.shape, 0)
                gc = lax.broadcasted_iota(INDEX_DTYPE, c_loc.shape, 1)
                c_loc = jnp.where(gc >= gr, c_loc, 0)
            csr = dense_to_csr(c_loc, cap_l)
            return csr.indptr[None], csr.indices[None], csr.values[None]

        ip, ix, vv = shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None),) * 6,
            out_specs=(P(axis, None),) * 3,
        )(a.indptrs, a.indices, a.values, b.indptrs, b.indices, b.values)
        return ip, ix, vv

    return fn


def spgemm_csr_distributed(
    a,
    b,
    shard_capacity: int | None = None,
    symmetric: bool = False,
    mesh: Optional[Mesh] = None,
    balance: str = "rows",
) -> ShardedCSR:
    """sparse x sparse -> row-sharded packed CSR across the mesh.

    The per-shard dense C row block never leaves the shard_map body: ring
    product and packed-CSR extraction are fused, the distributed
    replacement for the reference's count->allocate->stitch pipeline
    (``sparse_sparse_sparse.cpp:90-150``).  ``balance='flops'`` shards A by
    partial-product counts (:func:`flop_shard_bounds`) instead of row
    counts.  ``shard_capacity`` is the static per-shard entry budget
    (default: the dense row-block size, always sufficient).

    When the per-shard dense working set (A panel + B block + C panel)
    would exceed :attr:`Config.dense_shard_budget_bytes`, host-side
    operands auto-dispatch to the sparse local contraction
    (:func:`spgemm_csr_distributed_sparse`) -- the mesh then scales with
    nnz, not with the dense panel size.
    """
    mesh = mesh or row_mesh()
    if not isinstance(a, ShardedCSR):
        from ..config import get_config

        a_probe = _as_scipy(a)
        s_count = mesh.devices.size
        m, k = a_probe.shape
        n_cols = b.shape[1] if isinstance(b, ShardedCSR) else _as_scipy(b).shape[1]
        # Per-shard dense working set: A panel (rows_pad x k), B block
        # (kb x n), C panel (rows_pad x n).  rows_pad comes from the ACTUAL
        # bounds that will be used -- flop-balanced bounds can make one
        # shard far taller than m/S on skewed matrices.  The bounds are
        # computed ONCE here (covering ShardedCSR b via its global indptr,
        # a few-KB fetch) and reused for shard_csr below.
        if balance == "flops":
            bnds = flop_shard_bounds(a_probe, b, s_count)
            rows_pad = max(
                max(b1 - b0 for b0, b1 in zip(bnds[:-1], bnds[1:])), 1
            )
        else:
            bnds = None
            rows_pad = -(-m // s_count)
        kb = -(-k // s_count)
        itemsize = 8 if jax.config.jax_enable_x64 else 4
        panel_bytes = (rows_pad * k + kb * n_cols + rows_pad * n_cols) * itemsize
        if panel_bytes > get_config().dense_shard_budget_bytes:
            return spgemm_csr_distributed_sparse(
                a_probe, b, mesh=mesh, symmetric=symmetric, balance=balance
            )
        a = shard_csr(a_probe, mesh, bounds=bnds)
    b = _shard(b, mesh)
    _check_operands(a, b)
    m = a.shape[0]
    n = b.shape[1]
    cap_l = (
        int(shard_capacity)
        if shard_capacity is not None
        else a.rows_pad * n
    )
    ip, ix, vv = _spgemm_csr_jit(mesh, symmetric, cap_l)(a, b)
    return ShardedCSR(ip, ix, vv, (m, n), a.bounds)


# ---------------------------------------------------------------------------
# Sparse local contraction: the large-sparse regime (NO densification).
#
# spgemm_csr_distributed densifies each shard's rows, which caps the mesh at
# problems whose dense (rows_pad x n) panels fit per-device memory -- a 1M x 1M
# d=1e-5 operand is ~10 GB as CSR but its dense shard panels are terabytes.
# This path keeps EVERYTHING sparse: B blocks ring-rotate as packed CSR
# arrays (the wire moves 12 B/entry, not 8 B/element), and each ring step
# expands partial products ESC-style into a per-step segment of a static
# buffer; one lexicographic (row, col) sort + segment-sum after the ring
# builds the local output CSR.  Two int32 sort keys replace the int64
# row*n+col key, so n > 2^31/rows works without x64.
#
# Reference analogue: B held once and read by all workers
# (/root/reference/src/sparse_sparse_sparse.cpp:228-241); SURVEY section 5's
# "B row-blocks ring-streamed" plan.
# ---------------------------------------------------------------------------


def _sharded_global_indptr(b: ShardedCSR) -> np.ndarray:
    """Global CSR row pointers of a row-sharded matrix from its per-shard
    local pointers -- a few KB fetched, NOT the full operand (the capacity
    planner only needs row lengths)."""
    ips = np.asarray(b.indptrs)  # (S, rows_pad + 1), small
    bounds = b.row_bounds
    parts = [np.zeros(1, np.int64)]
    base = 0
    for s in range(len(bounds) - 1):
        rows_here = bounds[s + 1] - bounds[s]
        local = ips[s][1 : rows_here + 1].astype(np.int64)
        parts.append(base + local)
        base += int(ips[s][rows_here]) if rows_here else 0
    return np.concatenate(parts)


def _expand_step_capacity(a_sp, b_indptr, b_rows: int, bounds, s_count: int) -> tuple:
    """Host-side exact per-(shard, ring-step) expansion sizes.

    Returns (max over shard/step of partial products in one step,
    max over shards of total partial products) -- the two static
    capacities of the sparse ring kernel.  ``b_indptr`` is B's GLOBAL row
    pointer array (all that is needed from B).
    """
    kb = -(-b_rows // s_count) if b_rows else 1
    b_row_nnz = np.diff(b_indptr)
    per_entry = b_row_nnz[a_sp.indices].astype(np.int64)
    col_block = (a_sp.indices // kb).astype(np.int64)
    shard_of_entry = np.zeros(a_sp.nnz, np.int64)
    for s in range(s_count):
        lo, hi = int(a_sp.indptr[bounds[s]]), int(a_sp.indptr[bounds[s + 1]])
        shard_of_entry[lo:hi] = s
    key = shard_of_entry * s_count + col_block
    # Integer accumulation: np.bincount(weights=...) sums in float64, which
    # would round above 2**53 partials and could undersize e_step.
    per_step = np.zeros(s_count * s_count, np.int64)
    np.add.at(per_step, key, per_entry)
    per_shard = per_step.reshape(s_count, s_count).sum(axis=1)
    return int(per_step.max()) if per_step.size else 1, int(per_shard.max()) if per_shard.size else 1


def _expand_block_partials(
    slot, a_live, a_rows, a_ix, a_v, bip, bix, bv, col0, kb: int, e_step: int, f32: bool
):
    """One ring step's ESC expansion: partial products of the local A
    entries whose column falls in B block ``[col0, col0 + kb)`` against the
    block's packed CSR arrays.  Returns ``(i_loc, k_col, v, valid, total)``
    of length ``e_step`` (``total`` = live partial count this step; cummax
    forward-fill + packed gathers; the shared core of the sparse SpGEMM
    ring and the sparse triple-product ring)."""
    cap_a = a_ix.shape[0]
    e = jnp.arange(e_step, dtype=INDEX_DTYPE)
    zeros_e = jnp.zeros(e_step, INDEX_DTYPE)
    a_col_loc = a_ix - col0
    in_blk = a_live & (a_col_loc >= 0) & (a_col_loc < kb)
    safe_col = jnp.clip(a_col_loc, 0, kb - 1)
    bp0_entry = bip[safe_col]
    lens = jnp.where(in_blk, bip[safe_col + 1] - bp0_entry, 0)
    ends = jnp.cumsum(lens, dtype=INDEX_DTYPE)
    starts = ends - lens
    total = ends[-1] if cap_a > 0 else jnp.zeros((), INDEX_DTYPE)
    live_entry = in_blk & (lens > 0)
    seed_pos = jnp.where(live_entry, starts, e_step)
    src = lax.cummax(zeros_e.at[seed_pos].set(slot, mode="drop"))
    cap_b = max(bix.shape[0] - 1, 0)
    if f32:
        a_pack = jnp.stack(
            [
                bp0_entry,
                lax.bitcast_convert_type(a_v, jnp.int32),
                starts,
                a_rows,
            ],
            axis=1,
        )
        ga = a_pack[src]
        b_pos = jnp.clip(ga[:, 0] + (e - ga[:, 2]), 0, cap_b)
        i_loc = ga[:, 3]
        av = lax.bitcast_convert_type(ga[:, 1], jnp.float32)
        b_pack = jnp.stack([bix, lax.bitcast_convert_type(bv, jnp.int32)], axis=1)
        gb = b_pack[b_pos]
        k_col = gb[:, 0]
        v = av * lax.bitcast_convert_type(gb[:, 1], jnp.float32)
    else:
        start_f = lax.cummax(zeros_e.at[seed_pos].set(starts, mode="drop"))
        i_loc = lax.cummax(zeros_e.at[seed_pos].set(a_rows, mode="drop"))
        b_pos = jnp.clip(bp0_entry[src] + (e - start_f), 0, cap_b)
        k_col = bix[b_pos]
        v = a_v[src] * bv[b_pos]
    valid = e < total
    return i_loc, k_col, v, valid, jnp.minimum(total, e_step)


@functools.lru_cache(maxsize=None)
def _spgemm_sparse_jit(
    mesh: Mesh, symmetric: bool, e_step: int, cap_l: int, buf_cap: int,
    comm: bool = True,
):
    """Bidirectional sparse ring (round 5).

    * Both link directions carry B blocks at once: ``ceil(S/2)`` loop steps,
      each expanding a clockwise AND a counter-clockwise block
      (VERDICT r4 item 3).
    * Partials append at a CUMULATIVE per-shard offset into a
      ``buf_cap``-sized buffer instead of ``s_count`` static
      ``e_step``-strided segments: each block's write pads to ``e_step``
      but the next write starts at the true live count, overwriting the
      padded tail, so the buffer is sized by the shard's TOTAL work
      (``tot_max + e_step`` slack), not ``S x`` the worst single block
      (VERDICT r4 item 4, skew robustness).
    * ``comm=False`` replaces the permutes with identity -- the
      compute-only twin used by the weak-scaling breakdown artifact to
      separate ring-communication overhead from host contention
      (benchmarks/scaling.py).
    """
    (axis,) = mesh.axis_names
    s_count = mesh.devices.size

    @jax.jit
    def fn(a: ShardedCSR, b: ShardedCSR):
        m, k = a.shape
        n = b.shape[1]
        kb = b.rows_pad
        rows_pad = a.rows_pad
        bounds_arr = jnp.asarray(a.row_bounds, INDEX_DTYPE)
        val_dtype = jnp.result_type(a.values.dtype, b.values.dtype)
        BIG = jnp.asarray(jnp.iinfo(jnp.int32).max, jnp.int32)

        def local(a_ip2, a_ix2, a_v2, b_ip2, b_ix2, b_v2):
            a_ip = a_ip2.reshape(-1)
            a_ix = a_ix2.reshape(-1)
            a_v = a_v2.reshape(-1)
            my = lax.axis_index(axis)
            row0 = bounds_arr[my]
            cap_a = a_ix.shape[0]

            # Local row id of every A entry (padding -> row 0, value 0);
            # marker trick, not searchsorted (types.row_ids_from_indptr).
            slot = jnp.arange(cap_a, dtype=INDEX_DTYPE)
            nnz_a = a_ip[-1]
            rid = row_ids_from_indptr(a_ip, cap_a)
            a_rows = jnp.where(slot < nnz_a, rid, 0)
            a_live = slot < nnz_a

            perm_cw = [(i, (i - 1) % s_count) for i in range(s_count)]
            perm_ccw = [(i, (i + 1) % s_count) for i in range(s_count)]
            f32 = val_dtype == jnp.float32
            half = (s_count + 1) // 2
            ccw_steps = s_count // 2

            def permute(x, perm):
                return lax.ppermute(x, axis, perm) if comm else x

            rows_buf0 = _device_varying(jnp.full(buf_cap, BIG, jnp.int32), axis)
            cols_buf0 = _device_varying(jnp.full(buf_cap, BIG, jnp.int32), axis)
            vals_buf0 = _device_varying(jnp.zeros(buf_cap, val_dtype), axis)
            pos0 = _device_varying(jnp.zeros((), INDEX_DTYPE), axis)

            def emit(bufs, blk, j, active):
                """Expand block ``j`` and append its live partials at the
                shard's running offset.  The e_step-padded tail carries BIG
                keys; the NEXT append starts at pos + live count and
                overwrites it (final tail lands in the + e_step slack)."""
                rows_buf, cols_buf, vals_buf, pos = bufs
                b_ip_c, b_ix_c, b_v_c = blk
                col0 = (j * kb).astype(INDEX_DTYPE)
                i_loc, k_col, v, valid, count = _expand_block_partials(
                    slot,
                    a_live,
                    a_rows,
                    a_ix,
                    a_v,
                    b_ip_c.reshape(-1),
                    b_ix_c.reshape(-1),
                    b_v_c.reshape(-1),
                    col0,
                    kb,
                    e_step,
                    f32,
                )
                if symmetric:
                    valid = valid & (k_col >= i_loc + row0)
                valid = valid & active
                i_out = jnp.where(valid, i_loc, BIG)
                k_out = jnp.where(valid, k_col, BIG)
                v_out = jnp.where(valid, v, 0)
                rows_buf = lax.dynamic_update_slice(rows_buf, i_out, (pos,))
                cols_buf = lax.dynamic_update_slice(cols_buf, k_out, (pos,))
                vals_buf = lax.dynamic_update_slice(vals_buf, v_out, (pos,))
                # A masked-out (inactive) block appends nothing: its BIG-key
                # junk sits at pos and is overwritten by the next append.
                pos = pos + jnp.where(active, count, 0)
                return (rows_buf, cols_buf, vals_buf, pos)

            def body(t, carry):
                blk_cw, blk_ccw, bufs = carry
                # Next step's permutes first: no data dependence on this
                # step's expansions, so the link transfers overlap them.
                blk_cw_n = tuple(permute(x, perm_cw) for x in blk_cw)
                blk_ccw_n = tuple(permute(x, perm_ccw) for x in blk_ccw)
                j1 = (my + t) % s_count
                bufs = emit(bufs, blk_cw, j1, jnp.bool_(True))
                if s_count > 1:
                    j2 = (my - t - 1) % s_count
                    bufs = emit(bufs, blk_ccw, j2, t < ccw_steps)
                return (blk_cw_n, blk_ccw_n, bufs)

            blk0 = (b_ip2, b_ix2, b_v2)
            blk_ccw0 = (
                tuple(permute(x, perm_ccw) for x in blk0)
                if s_count > 1
                else blk0
            )
            (_, _, (rows_buf, cols_buf, vals_buf, _)) = lax.fori_loop(
                0,
                half,
                body,
                (blk0, blk_ccw0, (rows_buf0, cols_buf0, vals_buf0, pos0)),
            )

            # ---- sort + compress: shared ESC tail (fused int32 key when
            # the LOCAL output space fits; two-key lex sort otherwise).
            from ..ops.spgemm_jnp import esc_sort_compress

            indptr, indices, values = esc_sort_compress(
                rows_buf,
                cols_buf,
                vals_buf,
                n_rows=rows_pad,
                n_cols=n,
                out_capacity=cap_l,
            )
            return indptr[None], indices[None], values[None]

        ip, ix, vv = shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None),) * 6,
            out_specs=(P(axis, None),) * 3,
        )(a.indptrs, a.indices, a.values, b.indptrs, b.indices, b.values)
        return ip, ix, vv

    return fn


def spgemm_csr_distributed_sparse(
    a,
    b,
    mesh: Optional[Mesh] = None,
    symmetric: bool = False,
    balance: str = "flops",
    expand_step_capacity: int | None = None,
    shard_capacity: int | None = None,
    partials_capacity: int | None = None,
    _comm: bool = True,
) -> ShardedCSR:
    """Distributed SpGEMM with a SPARSE local contraction (large-sparse).

    Nothing is ever densified: A/C stay row-sharded packed CSR, B blocks
    ring-rotate as packed CSR arrays, and each shard runs an
    expand-(lex)sort-compress pipeline over its accumulated partial
    products.  This is the mesh engine for matrices that only exist as CSR
    -- the regime where :func:`spgemm_csr_distributed`'s per-shard dense
    panels would exceed device memory.

    ``expand_step_capacity`` / ``shard_capacity`` are the two static
    budgets (max partial products per ring step; per-shard output entries).
    They are computed exactly on host when ``a``/``b`` arrive as scipy
    matrices, and must be supplied when passing pre-placed
    :class:`ShardedCSR` operands.  ``partials_capacity`` sizes the
    per-shard partial-product buffer: the default is the exact per-shard
    TOTAL work (+ one step of slack) when host-planned, or the
    skew-pessimal ``S x expand_step_capacity`` for pre-placed operands --
    round 5 skew fix: one heavy (shard, block) pair no longer inflates
    every shard's buffer by ``S x`` (VERDICT r4 item 4).
    """
    mesh = mesh or row_mesh()
    s_count = mesh.devices.size
    if not isinstance(a, ShardedCSR):
        a_sp = _as_scipy(a)
        # B's structure planning needs only its GLOBAL indptr: a pre-placed
        # ShardedCSR stays on device (fetching a few KB of row pointers),
        # instead of a full gather-and-reupload round trip.
        if isinstance(b, ShardedCSR):
            b_indptr = _sharded_global_indptr(b)
            b_rows, b_cols = b.shape
        else:
            b = _as_scipy(b)
            b_indptr = b.indptr
            b_rows, b_cols = b.shape
        if balance == "flops":
            from .partition import flop_balanced_partition, row_flops

            flops = row_flops(a_sp.indptr, a_sp.indices, b_indptr)
            bounds = _pad_bounds(
                flop_balanced_partition(flops, s_count), a_sp.shape[0], s_count
            )
        else:
            bounds = _uniform_bounds(a_sp.shape[0], s_count)
        if (
            expand_step_capacity is None
            or shard_capacity is None
            or partials_capacity is None
        ):
            e_max, tot_max = _expand_step_capacity(
                a_sp, b_indptr, b_rows, bounds, s_count
            )
            if expand_step_capacity is None:
                # Fine (<= 1/16 slack) capacity, not power-of-two: this
                # program compiles once per operand STRUCTURE anyway, and
                # under skew the pow2 round-up alone can double the
                # partials buffer below.
                from ..utils.transfer import fine_capacity

                expand_step_capacity = fine_capacity(e_max)
            if shard_capacity is None:
                shard_capacity = bucket_capacity(
                    min(tot_max, a_sp.shape[0] * b_cols)
                )
            if partials_capacity is None:
                # Exact per-shard total + one padded step of slack (the
                # cumulative-offset append overwrites each step's padded
                # tail; only the LAST tail needs real room).
                from ..utils.transfer import fine_capacity

                partials_capacity = (
                    fine_capacity(tot_max) + int(expand_step_capacity)
                )
        a = shard_csr(a_sp, mesh, bounds=bounds)
        b = _shard(b, mesh)
    else:
        b = _shard(b, mesh)
        if expand_step_capacity is None or shard_capacity is None:
            raise ValueError(
                "pre-placed ShardedCSR operands need explicit "
                "expand_step_capacity and shard_capacity"
            )
        if partials_capacity is None:
            # No host structure to size from: skew-pessimal upper bound.
            partials_capacity = (s_count + 1) * int(expand_step_capacity)
    _check_operands(a, b)
    fn = _spgemm_sparse_jit(
        mesh,
        symmetric,
        int(expand_step_capacity),
        int(shard_capacity),
        int(partials_capacity),
        comm=_comm,
    )
    ip, ix, vv = fn(a, b)
    return ShardedCSR(ip, ix, vv, (a.shape[0], b.shape[1]), a.bounds)


# ---------------------------------------------------------------------------
# Sparse distributed triple product: H . Q . H^T without densifying H or Q.
#
# The dense triple-product ring below densifies every shard's H and Q panels
# (rows_pad x k), which caps it at problems whose dense panels fit per-device
# memory.  For SURVEY section-5-scale sparse H/Q this path computes
# T = H.Q with the sparse-local-contraction ring (never densified), then
# C = T.H^T as a SECOND sparse ring: H^T row blocks (contraction dim k)
# ring-rotate as packed CSR, each step ESC-expands the matching T columns
# and scatter-adds the partials straight into the per-shard DENSE C panel
# (rows_pad x m) -- the only dense object, and it scales with the OUTPUT,
# not with k.  Step capacity comes from a device-side symbolic count pass
# (one tiny dispatch), the device analogue of the reference's two-phase
# sizing.  Reference: /root/reference/src/sparse_sparse_dense.cpp:141-249.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _triple_count_jit(mesh: Mesh):
    """Per-(shard, ring-step) partial-product counts for the second ring:
    counts[s][j] = sum of nnz(H^T row col) over T-shard-s entries whose
    column lies in H^T block j."""
    (axis,) = mesh.axis_names
    s_count = mesh.devices.size

    @jax.jit
    def fn(t_indptrs, t_indices, nnzht_pad):
        kb = nnzht_pad.shape[0] // s_count

        def local(t_ip2, t_ix2, nz):
            t_ip = t_ip2.reshape(-1)
            t_ix = t_ix2.reshape(-1)
            cap = t_ix.shape[0]
            slot = jnp.arange(cap, dtype=INDEX_DTYPE)
            live = slot < t_ip[-1]
            safe = jnp.clip(t_ix, 0, nz.shape[0] - 1)
            w = jnp.where(live, nz[safe], 0)
            blk = jnp.clip(safe // kb, 0, s_count - 1)
            counts = jnp.zeros(s_count, INDEX_DTYPE).at[blk].add(w)
            return counts[None]

        return shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P()),
            out_specs=P(axis, None),
        )(t_indptrs, t_indices, nnzht_pad)

    return fn


@functools.lru_cache(maxsize=None)
def _triple_sparse_jit(mesh: Mesh, e_step: int, full: bool):
    (axis,) = mesh.axis_names
    s_count = mesh.devices.size

    @jax.jit
    def fn(t: ShardedCSR, ht: ShardedCSR):
        m, k = t.shape
        m_out = ht.shape[1]
        kb = ht.rows_pad
        rows_pad = t.rows_pad
        bounds_arr = jnp.asarray(t.row_bounds, INDEX_DTYPE)
        val_dtype = jnp.result_type(t.values.dtype, ht.values.dtype)

        def local(t_ip2, t_ix2, t_v2, h_ip2, h_ix2, h_v2):
            t_ip = t_ip2.reshape(-1)
            t_ix = t_ix2.reshape(-1)
            t_v = t_v2.reshape(-1)
            my = lax.axis_index(axis)
            row0 = bounds_arr[my]
            cap_t = t_ix.shape[0]
            slot = jnp.arange(cap_t, dtype=INDEX_DTYPE)
            nnz_t = t_ip[-1]
            rid = row_ids_from_indptr(t_ip, cap_t)
            t_rows = jnp.where(slot < nnz_t, rid, 0)
            t_live = slot < nnz_t
            perm = [(i, (i - 1) % s_count) for i in range(s_count)]
            f32 = val_dtype == jnp.float32
            acc0 = _device_varying(jnp.zeros(rows_pad * m_out, val_dtype), axis)

            def body(s, carry):
                h_ip_c, h_ix_c, h_v_c, acc = carry
                h_ip_n = lax.ppermute(h_ip_c, axis, perm)
                h_ix_n = lax.ppermute(h_ix_c, axis, perm)
                h_v_n = lax.ppermute(h_v_c, axis, perm)
                j = (my + s) % s_count
                col0 = (j * kb).astype(INDEX_DTYPE)
                i_loc, k_col, v, valid, _ = _expand_block_partials(
                    slot,
                    t_live,
                    t_rows,
                    t_ix,
                    t_v,
                    h_ip_c.reshape(-1),
                    h_ix_c.reshape(-1),
                    h_v_c.reshape(-1),
                    col0,
                    kb,
                    e_step,
                    f32,
                )
                if not full:
                    # Upper triangle in GLOBAL coordinates, filtered during
                    # expansion (halves the scatter work vs mirror-later).
                    valid = valid & (k_col >= i_loc + row0)
                pos = jnp.where(
                    valid, i_loc * m_out + k_col, jnp.asarray(rows_pad * m_out, INDEX_DTYPE)
                )
                acc = acc.at[pos].add(jnp.where(valid, v, 0), mode="drop")
                return (h_ip_n, h_ix_n, h_v_n, acc)

            (_, _, _, acc) = lax.fori_loop(
                0, s_count, body, (h_ip2, h_ix2, h_v2, acc0)
            )
            return acc.reshape(rows_pad, m_out)

        c = shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None),) * 6,
            out_specs=P(axis, None),
        )(t.indptrs, t.indices, t.values, ht.indptrs, ht.indices, ht.values)
        return c[:m]

    return fn


def triple_product_distributed_sparse(
    h,
    q,
    compute_full_matrix: int = 0,
    mesh: Optional[Mesh] = None,
    expand_step_capacity: int | None = None,
):
    """Fused distributed ``H . Q . H^T`` for LARGE-SPARSE operands.

    Neither H nor Q is ever densified: ``T = H.Q`` runs the
    sparse-local-contraction ring, then ``C = T.H^T`` runs a second sparse
    ring over row-sharded H^T with dense per-shard accumulation into the
    (rows_pad x m) output panel -- the only dense object, sized by the
    OUTPUT, not by the contraction dimension.  The second ring's static
    step capacity comes from a device-side symbolic count dispatch unless
    supplied.  Returns the dense (m, m) product (upper triangle, or full
    with ``compute_full_matrix=1``), like :func:`triple_product_distributed`.
    """
    from ..config import get_config

    mesh = mesh or row_mesh()
    s_count = mesh.devices.size
    h_sp = _as_scipy(h)
    m, k = h_sp.shape
    rows_pad = -(-m // s_count)
    itemsize = 8 if jax.config.jax_enable_x64 else 4
    budget = get_config().dense_shard_budget_bytes
    if rows_pad * m * itemsize > budget:
        raise ValueError(
            f"sparse triple product accumulates a dense ({rows_pad} x {m}) "
            f"C panel per shard = {rows_pad * m * itemsize} bytes, over "
            f"dense_shard_budget_bytes={budget}; raise the budget or add "
            "devices (the panel shrinks as rows_pad = ceil(m / devices))"
        )
    if rows_pad * m >= 2**31:
        # The accumulation kernel scatters into the flattened C panel with
        # int32 indices (x64 may be off) -- a hard ceiling the budget
        # knob cannot lift.  Adding devices shrinks rows_pad.
        raise ValueError(
            f"per-shard C panel has {rows_pad * m} elements >= 2**31 (the "
            "int32 flat-index ceiling of the scatter kernel); add devices "
            "so rows_pad = ceil(m / devices) brings rows_pad * m under 2**31"
        )
    t = spgemm_csr_distributed_sparse(h_sp, q, mesh=mesh, balance="rows")
    ht_sp = h_sp.T.tocsr()
    ht = shard_csr(ht_sp, mesh)
    _check_operands(t, ht)
    if expand_step_capacity is None:
        kb = ht.rows_pad
        nnzht = np.zeros(s_count * kb, np.int32)
        nnzht[:k] = np.diff(ht_sp.indptr)
        counts = _triple_count_jit(mesh)(t.indptrs, t.indices, jnp.asarray(nnzht))
        # Multi-host safe reduction: only replicated SCALARS cross to host
        # (np.asarray of a cross-process-sharded array raises), computed
        # with one tiny jitted reduce.
        counts_max, counts_neg = (
            int(x)
            for x in jax.jit(
                lambda c: (jnp.max(c), jnp.sum(c < 0, dtype=jnp.int32))
            )(counts)
        )
        # The device count pass accumulates in int32: a (shard, step) pair
        # with >= 2**31 partials would wrap and silently undersize e_step.
        # Negative counts catch any single wrap; the host-side int64 bound
        # (per-shard nnz(T) x max nnz(H^T row) >= any true step count)
        # closes the double-wrap window.  A step that heavy cannot be
        # buffered on one chip anyway -- the fix is more devices or an
        # explicit expand_step_capacity.
        per_shard_nnz_t = int(
            jax.jit(lambda ips: jnp.max(ips[:, -1]))(t.indptrs)
        )
        step_bound = per_shard_nnz_t * int(nnzht.max(initial=0))
        if counts_neg or step_bound >= 2**32:
            raise OverflowError(
                f"per-(shard, ring-step) partial-product count overflowed "
                f"int32 (host-side upper bound {step_bound}); add devices "
                f"or pass expand_step_capacity explicitly"
            )
        expand_step_capacity = bucket_capacity(max(counts_max, 1))
    return _triple_sparse_jit(
        mesh, int(expand_step_capacity), bool(compute_full_matrix)
    )(t, ht)


# ---------------------------------------------------------------------------
# Fused distributed triple product H . Q . H^T.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _triple_product_jit(mesh: Mesh):
    (axis,) = mesh.axis_names
    s_count = mesh.devices.size

    @jax.jit
    def fn(h: ShardedCSR, q: ShardedCSR):
        m, k = h.shape
        kb = q.rows_pad
        rows_pad = h.rows_pad
        out_dtype = jnp.result_type(h.values.dtype, q.values.dtype)
        k_pad = max(s_count * kb, k)

        def local(h_ip, h_ix, h_v, q_ip, q_ix, q_v):
            h_loc = _local_dense(h_ip, h_ix, h_v, rows_pad, k)
            h_pad = pad_to_multiple(h_loc, 1, k_pad) if k < k_pad else h_loc
            q_loc = _local_dense(q_ip, q_ix, q_v, kb, k)
            # Ring 1: T = H . Q, row-sharded; T never leaves this shard.
            t_loc = _ring_accumulate(h_pad, q_loc, axis, s_count, kb, out_dtype)
            t_pad = pad_to_multiple(t_loc, 1, k_pad) if k < k_pad else t_loc
            # Ring 2: C = T . H^T -- H's own row blocks rotate; each step
            # fills the column block of C owned by the sending shard.
            my = lax.axis_index(axis)
            perm = [(i, (i - 1) % s_count) for i in range(s_count)]

            def body(s, carry):
                h_cur, acc = carry
                h_next = lax.ppermute(h_cur, axis, perm)  # overlaps the dot
                j = ((my + s) % s_count).astype(jnp.int32)
                blk = jnp.dot(
                    t_pad,
                    h_cur.T,
                    precision="highest",
                    preferred_element_type=out_dtype,
                )
                acc = lax.dynamic_update_slice(
                    acc, blk, (jnp.zeros((), jnp.int32), j * rows_pad)
                )
                return (h_next, acc)

            acc0 = jnp.zeros((rows_pad, s_count * rows_pad), out_dtype)
            acc0 = _device_varying(acc0, axis)
            (_, c_loc) = lax.fori_loop(0, s_count, body, (h_pad, acc0))
            return c_loc

        c = shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None),) * 6,
            out_specs=P(axis, None),
        )(h.indptrs, h.indices, h.values, q.indptrs, q.indices, q.values)
        return c[:m, :m]

    return fn


def triple_product_distributed(
    h,
    q,
    compute_full_matrix: int = 0,
    mesh: Optional[Mesh] = None,
):
    """Fused distributed ``H . Q . H^T``.

    Both contractions are rings over sharded operands; the intermediate
    ``T = H.Q`` stays row-sharded on the chips that produced it (never
    gathered, never sparse-materialized), mirroring the reference's fused
    contract (``/root/reference/src/sparse_sparse_dense.cpp:141-249``)
    without its O(threads . n^2) thread-local copies.

    Host-side operands whose dense shard panels would exceed
    :attr:`Config.dense_shard_budget_bytes` auto-dispatch to
    :func:`triple_product_distributed_sparse` (no densification of H or Q;
    the mesh then scales with nnz and with the OUTPUT size).
    """
    mesh = mesh or row_mesh()
    if not isinstance(h, ShardedCSR):
        from ..config import get_config

        h_probe = _as_scipy(h)
        s_count = mesh.devices.size
        m, k = h_probe.shape
        rows_pad = -(-m // s_count)
        kb = -(-k // s_count)
        k_pad = max(s_count * kb, k)
        itemsize = 8 if jax.config.jax_enable_x64 else 4
        # Dense working set per shard: H panel + Q block + T panel + C block.
        panel_bytes = (
            rows_pad * k_pad * 2 + kb * k + rows_pad * s_count * rows_pad
        ) * itemsize
        if panel_bytes > get_config().dense_shard_budget_bytes:
            return triple_product_distributed_sparse(
                h_probe, q, compute_full_matrix, mesh=mesh
            )
        h = h_probe
    h = _shard(h, mesh)
    q = _shard(q, mesh)
    _check_operands(h, q)
    if h.bounds is not None and h.bounds != _uniform_bounds(h.shape[0], h.n_shards):
        raise ValueError("triple product requires uniformly row-sharded H")
    c = _triple_product_jit(mesh)(h, q)
    upper = jnp.triu(c)
    if compute_full_matrix:
        return upper + jnp.triu(c, 1).T
    return upper


# ---------------------------------------------------------------------------
# Dense-operand ring matmul (utility; operands already dense on host/device).
# ---------------------------------------------------------------------------


def _ring_matmul_local(a_loc, b_loc, axis: str, n: int):
    blk = a_loc.shape[1] // n
    out_dtype = jnp.result_type(a_loc, b_loc)
    return _ring_accumulate(a_loc, b_loc, axis, n, blk, out_dtype)


def ring_matmul(
    a: jax.Array,
    b: jax.Array,
    mesh: Optional[Mesh] = None,
) -> jax.Array:
    """Dense distributed ``a @ b`` with ring-rotated B blocks.

    ``a`` is (m, k), ``b`` is (k, c); both are padded so m and k divide the
    mesh size.  Returns the (m, c) product (padding trimmed).
    """
    mesh = mesh or row_mesh()
    (axis,) = mesh.axis_names
    n = mesh.devices.size
    m, k = a.shape
    c = b.shape[1]

    ap = pad_to_multiple(a, 0, n)
    ap = pad_to_multiple(ap, 1, n)
    bp = pad_to_multiple(b, 0, n)

    fn = shard_map(
        functools.partial(_ring_matmul_local, axis=axis, n=n),
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=P(axis, None),
    )
    out = fn(ap, bp)
    return out[:m, :c]
