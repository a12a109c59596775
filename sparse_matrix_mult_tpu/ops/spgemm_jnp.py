"""Expansion-sort SpGEMM: the scalable sparse->sparse path, pure XLA.

The reference implements Gustavson's algorithm: a row-serial scatter into a
dense "sparse accumulator" work array with grow-on-demand output buffers
(``/root/reference/src/sparsework.cpp:56-129``).  Neither dynamic growth nor
data-dependent scatter loops map onto XLA.  The device formulation is
**ESC (expand-sort-compress)**:

1. *Expand*  -- materialize every partial product ``A(i,j) * B(j,k)`` as a
   ``(key=i*cols+k, value)`` pair.  The source-entry id per expansion
   slot comes from a ``lax.cummax`` forward-fill over scattered seeds
   (entry ids are monotone in expansion position), and all per-entry
   fields ride ONE packed multi-column row gather instead of one gather
   per field.
2. *Sort*    -- one device-wide key sort (``lax.sort_key_val``).
3. *Compress*-- (v2) shifted-add dedup network + compaction sort; see
   :func:`esc_sort_compress`.  This replaces both the per-thread partials
   and the serial stitch of the reference orchestrators
   (``sparse_sparse_sparse.cpp:90-150``).

Row ids come from a marker-scatter + cumsum rather than a searchsorted
(whose lowering is a while loop of dependent steps).  Exact structure
throughout; not measured on the H100.

Everything is static-shape: callers supply ``expand_capacity`` (>= total
partial products) and ``out_capacity`` (>= nnz(C)); the host API computes
exact values cheaply from the operand structure and buckets them
(:func:`sparse_matrix_mult_tpu.types.bucket_capacity`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..types import CSRMatrix, INDEX_DTYPE

__all__ = [
    "spgemm_esc",
    "spgemm_esc_windowed",
    "precompute_window_table",
    "esc_sort_compress",
    "expansion_size",
]

# Duplicate (i, k) runs up to 2**_DEDUP_STEPS long are summed by the cheap
# shifted-add network in esc_sort_compress; longer runs trigger the exact
# scatter fallback via lax.cond (both branches compiled, one executed).
_DEDUP_STEPS = 3
_DEDUP_SPAN = 1 << _DEDUP_STEPS


def expansion_size(a_indices, a_nnz: int, b_indptr) -> int:
    """Exact number of partial products, computed on host.

    Equals the flop count the reference's ``limits`` partitioning balances
    over threads (``/root/reference/src/workdivision.cpp:16-89``).  Runs in
    the native host library (OpenMP) when available.
    """
    from ..utils.native import expansion_size as _native_expansion_size

    return _native_expansion_size(a_indices, a_nnz, b_indptr)


@functools.partial(
    jax.jit,
    static_argnames=("expand_capacity", "out_capacity", "symmetric"),
)
def spgemm_esc(
    a: CSRMatrix,
    b: CSRMatrix,
    *,
    expand_capacity: int,
    out_capacity: int,
    symmetric: bool = False,
    row_offset=0,
) -> CSRMatrix:
    """Compute ``C = A @ B`` in padded CSR via expand-sort-compress.

    With ``symmetric=True`` only upper-triangle entries (k >= i) are emitted,
    mirroring ``sparsework_sym``'s filter
    (``/root/reference/src/sparsework.cpp:217``).  ``row_offset`` (traced
    scalar) is the global row index of ``a``'s first row, so the symmetric
    filter stays globally correct when the caller processes A in row chunks
    (the chunked large-sparse path in :mod:`sparse_matrix_mult_tpu.api`).
    """
    rows, _ = a.shape
    _, cols = b.shape

    # Two-key (row, col) lexicographic sort: int32 everywhere, no
    # ``rows * cols < 2**31`` limit (the old single int32 ``i*cols + k``
    # key overflowed past that; int64 keys needed x64).
    big = jnp.array(jnp.iinfo(jnp.int32).max, jnp.int32)

    # ---- expand -----------------------------------------------------------
    # Per-expansion-slot source info is propagated by a forward-fill
    # associative scan instead of a searchsorted + per-slot gathers: the
    # scan is a few full-bandwidth passes.
    # Each A entry seeds its payload (row id, a value, B row start, slot
    # start) at its expansion start offset -- distinct for every entry with
    # a nonempty B row -- and the scan fills it forward across the entry's
    # expansion range.  Only the two unavoidable B-side gathers remain.
    a_slot = jnp.arange(a.capacity, dtype=INDEX_DTYPE)
    a_valid = a_slot < a.nnz
    a_rows = a.row_ids()
    b_row_nnz = b.indptr[1:] - b.indptr[:-1]  # (K,)
    lens = jnp.where(a_valid, b_row_nnz[a.indices], 0)
    ends = jnp.cumsum(lens, dtype=INDEX_DTYPE)
    starts = ends - lens
    total = ends[-1] if a.capacity > 0 else jnp.zeros((), INDEX_DTYPE)

    e = jnp.arange(expand_capacity, dtype=INDEX_DTYPE)
    live_entry = a_valid & (lens > 0)
    seed_pos = jnp.where(live_entry, starts, expand_capacity)  # OOB -> dropped
    zeros_e = jnp.zeros(expand_capacity, INDEX_DTYPE)
    # Forward-fill by cummax: entry ids are nondecreasing in expansion
    # position, so a native cumulative-max over scattered seeds propagates
    # each live entry's id across its expansion range (one XLA cumulative
    # op -- a pytree associative_scan variant unrolls into a much larger
    # program; cummax compiles in seconds).
    src = lax.cummax(zeros_e.at[seed_pos].set(a_slot, mode="drop"))
    b_start = b.indptr[a.indices]  # (cap_a,) B row start per A entry
    f32 = a.values.dtype == jnp.float32 and b.values.dtype == jnp.float32
    if f32:
        # Pack all per-entry fields into one (cap_a, 4) i32 table: one
        # multi-column row gather replaces three expansion-sized gathers.
        a_pack = jnp.stack(
            [
                b_start,
                lax.bitcast_convert_type(a.values, jnp.int32),
                starts,
                a_rows,
            ],
            axis=1,
        )
        ga = a_pack[src]
        bp0, av_bits, start_f, i = ga[:, 0], ga[:, 1], ga[:, 2], ga[:, 3]
        av = lax.bitcast_convert_type(av_bits, jnp.float32)
        b_pos = jnp.clip(bp0 + (e - start_f), 0, max(b.capacity - 1, 0))
        b_pack = jnp.stack(
            [b.indices, lax.bitcast_convert_type(b.values, jnp.int32)], axis=1
        )
        gb = b_pack[b_pos]
        k = gb[:, 0]
        v = av * lax.bitcast_convert_type(gb[:, 1], jnp.float32)
    else:
        start_f = lax.cummax(zeros_e.at[seed_pos].set(starts, mode="drop"))
        i = lax.cummax(zeros_e.at[seed_pos].set(a_rows, mode="drop"))
        b_pos = jnp.clip(b_start[src] + (e - start_f), 0, max(b.capacity - 1, 0))
        k = b.indices[b_pos]
        v = a.values[src] * b.values[b_pos]

    valid = e < total
    if symmetric:
        valid = valid & (k >= i + jnp.asarray(row_offset, INDEX_DTYPE))

    indptr, indices, values = esc_sort_compress(
        jnp.where(valid, i, big),
        jnp.where(valid, k, big),
        v,
        n_rows=rows,
        n_cols=cols,
        out_capacity=out_capacity,
    )
    return CSRMatrix(indptr=indptr, indices=indices, values=values, shape=(rows, cols))


def _b_pack(b: CSRMatrix) -> jax.Array:
    """(capacity, 2) int32 [col | f32-value bits] table of B's entries."""
    return jnp.stack(
        [b.indices, lax.bitcast_convert_type(b.values, jnp.int32)], axis=1
    )


def _window_table(b: CSRMatrix, window: int, b_pack: jax.Array) -> jax.Array:
    """(K, 2 + 2W) int32 [len | start | cols | value bits] windowed view of
    B's first ``window`` entries per row (one K*W-index gather)."""
    W = int(window)
    b_starts = b.indptr[:-1]
    b_lens = b.indptr[1:] - b.indptr[:-1]
    wr = jnp.arange(W, dtype=INDEX_DTYPE)
    pos = jnp.clip(b_starts[:, None] + wr[None, :], 0, max(b.capacity - 1, 0))
    ell = b_pack[pos]
    return jnp.concatenate(
        [jnp.stack([b_lens, b_starts], axis=1), ell[:, :, 0], ell[:, :, 1]],
        axis=1,
    )


@functools.partial(jax.jit, static_argnames=("window",))
def precompute_window_table(b: CSRMatrix, window: int) -> jax.Array:
    """Device-side windowed (ELLPACK) table of B for repeated products.

    Returns the ``(K, 2 + 2W)`` int32 table ``[len | start | cols | value
    bits]`` that :func:`spgemm_esc_windowed` builds internally (f32 values
    only).  Pipelines that multiply many A's against one B (the reference's
    motivating workload holds Q and H fixed across an inversion,
    ``/root/reference/README.md:140``) can build it once and pass it as
    ``b_table=``.  This is a COMPOSITION convenience, not a measured
    speedup -- XLA may fuse the inline table build into the expansion at
    least as well as it reads a materialized table, so prefer the inline
    path unless the table is shared across differently-shaped programs.
    """
    if b.values.dtype != jnp.float32:
        raise ValueError("window tables are f32-only (bitcast packing)")
    return _window_table(b, window, _b_pack(b))


@functools.partial(
    jax.jit,
    static_argnames=(
        "window",
        "expand_capacity",
        "tail_capacity",
        "out_capacity",
        "symmetric",
    ),
)
def spgemm_esc_windowed(
    a: CSRMatrix,
    b: CSRMatrix,
    *,
    window: int,
    expand_capacity: int,
    tail_capacity: int,
    out_capacity: int,
    symmetric: bool = False,
    row_offset=0,
    b_table: jax.Array | None = None,
) -> CSRMatrix:
    """ESC with a windowed (ELLPACK) expansion: the hypersparse fast path.

    The classic :func:`spgemm_esc` expansion pays two expansion-sized
    (~``E``-index) gathers plus a seeds scatter and a ``cummax``.  When
    B's rows are short, the same partial products can be
    produced from a fixed ``window``-wide view of each B row:

    1. Pack B's first ``window`` entries per row into an ELLPACK table
       ``(K, 1 + 2W)`` = [row nnz | cols | values-as-int32] with one
       windowed gather (``K*W`` indices, K = B rows).
    2. ONE row gather of that table per A entry (``nnz(A)`` indices --
       a row gather's width is nearly free) replaces the
       per-partial a-side gather, the b-side gather, the seeds scatter,
       AND the cummax: the A-side fields broadcast along the window axis.
    3. B rows longer than ``window`` spill their remainder into a tail
       expansion (capacity ``tail_capacity``, the round-3 cummax
       machinery) -- exact for any skew; when the host planner sets
       ``tail_capacity=0`` the tail code is not even traced.

    The padded partials (``nnz(A) * window + tail``) carry int32-max keys
    on dead slots; the shared :func:`esc_sort_compress` first sort parks
    them past ``expand_capacity`` and every later stage runs at the exact
    expansion size.  Replaces the same reference hot loop as
    :func:`spgemm_esc` (``/root/reference/src/sparsework.cpp:56-129``).
    """
    rows, _ = a.shape
    kdim, cols = b.shape
    W = int(window)
    if b_table is not None and b_table.shape != (kdim, 2 + 2 * W):
        raise ValueError(
            f"b_table shape {b_table.shape} != ({kdim}, {2 + 2 * W}); build "
            f"it with precompute_window_table(b, window={W})"
        )
    big = jnp.array(jnp.iinfo(jnp.int32).max, jnp.int32)
    off = jnp.asarray(row_offset, INDEX_DTYPE)

    a_slot = jnp.arange(a.capacity, dtype=INDEX_DTYPE)
    a_valid = a_slot < a.nnz
    a_rows = a.row_ids()
    a_idx_safe = jnp.where(a_valid, a.indices, 0)

    wr = jnp.arange(W, dtype=INDEX_DTYPE)
    f32 = a.values.dtype == jnp.float32 and b.values.dtype == jnp.float32
    if f32:
        b_pack = _b_pack(b)  # also feeds the tail gathers below
        tbl = b_table if b_table is not None else _window_table(b, W, b_pack)
        ga = tbl[a_idx_safe]  # (cap_a, 2+2W) row gather: nnz(A) indices
        lens = jnp.where(a_valid, ga[:, 0], 0)
        start_tail = ga[:, 1] + W
        k2 = ga[:, 2 : 2 + W]
        bv = lax.bitcast_convert_type(ga[:, 2 + W :], jnp.float32)
    else:
        # f64 correctness path (CPU parity): unpacked gathers, no bitcast.
        b_starts = b.indptr[:-1]
        b_lens = b.indptr[1:] - b.indptr[:-1]
        pos = jnp.clip(b_starts[:, None] + wr[None, :], 0, max(b.capacity - 1, 0))
        ell_k = b.indices[pos]
        ell_v = b.values[pos]
        lens = jnp.where(a_valid, b_lens[a_idx_safe], 0)
        start_tail = b_starts[a_idx_safe] + W
        k2 = ell_k[a_idx_safe]
        bv = ell_v[a_idx_safe]
    v2 = a.values[:, None] * bv
    i2 = jnp.broadcast_to(a_rows[:, None], (a.capacity, W))
    valid2 = a_valid[:, None] & (wr[None, :] < jnp.minimum(lens, W)[:, None])
    if symmetric:
        valid2 = valid2 & (k2 >= i2 + off)
    fused = rows * cols < 2**31
    if fused:
        # Build the fused sort key directly in the 2D layout -- skips two
        # expansion-sized where/reshape passes vs handing (i, k) separately.
        i_p = None
        k_p = jnp.where(valid2, i2 * cols + k2, big).reshape(-1)
    else:
        i_p = jnp.where(valid2, i2, big).reshape(-1)
        k_p = jnp.where(valid2, k2, big).reshape(-1)
    v_p = v2.reshape(-1)

    if tail_capacity > 0:
        lens_t = jnp.maximum(lens - W, 0)
        ends_t = jnp.cumsum(lens_t, dtype=INDEX_DTYPE)
        starts_t = ends_t - lens_t
        total_t = ends_t[-1] if a.capacity > 0 else jnp.zeros((), INDEX_DTYPE)
        et = jnp.arange(tail_capacity, dtype=INDEX_DTYPE)
        seed_pos = jnp.where(lens_t > 0, starts_t, tail_capacity)
        zeros_t = jnp.zeros(tail_capacity, INDEX_DTYPE)
        src = lax.cummax(zeros_t.at[seed_pos].set(a_slot, mode="drop"))
        if f32:
            a_pack = jnp.stack(
                [
                    start_tail,
                    lax.bitcast_convert_type(a.values, jnp.int32),
                    starts_t,
                    a_rows,
                ],
                axis=1,
            )
            gat = a_pack[src]
            b_pos = jnp.clip(gat[:, 0] + (et - gat[:, 2]), 0, max(b.capacity - 1, 0))
            gb = b_pack[b_pos]
            k_t = gb[:, 0]
            v_t = lax.bitcast_convert_type(gat[:, 1], jnp.float32) * (
                lax.bitcast_convert_type(gb[:, 1], jnp.float32)
            )
            i_t = gat[:, 3]
        else:
            start_f = lax.cummax(zeros_t.at[seed_pos].set(starts_t, mode="drop"))
            i_t = lax.cummax(zeros_t.at[seed_pos].set(a_rows, mode="drop"))
            b_pos = jnp.clip(
                start_tail[src] + (et - start_f), 0, max(b.capacity - 1, 0)
            )
            k_t = b.indices[b_pos]
            v_t = a.values[src] * b.values[b_pos]
        valid_t = et < total_t
        if symmetric:
            valid_t = valid_t & (k_t >= i_t + off)
        if fused:
            k_p = jnp.concatenate(
                [k_p, jnp.where(valid_t, i_t * cols + k_t, big)]
            )
        else:
            i_p = jnp.concatenate([i_p, jnp.where(valid_t, i_t, big)])
            k_p = jnp.concatenate([k_p, jnp.where(valid_t, k_t, big)])
        v_p = jnp.concatenate([v_p, v_t])

    indptr, indices, values = esc_sort_compress(
        i_p,
        k_p,
        v_p,
        n_rows=rows,
        n_cols=cols,
        out_capacity=out_capacity,
        live_capacity=min(int(expand_capacity), k_p.shape[0]),
    )
    return CSRMatrix(indptr=indptr, indices=indices, values=values, shape=(rows, cols))


def windowed_plan(a_nnz: int, b_referenced_lens, expand: int):
    """Host-side planner for :func:`spgemm_esc_windowed`.

    ``b_referenced_lens``: nnz of each B row *referenced by an A entry*
    (one entry per A nonzero, i.e. ``diff(b.indptr)[a.indices]``).
    Returns ``(window, tail)`` -- the smallest window in {4,...,64}
    whose padded volume ``a_nnz*W + tail`` stays under ~2.5x the exact
    expansion -- or ``None`` when no window qualifies (B rows too long:
    the classic expansion is denser in that regime).
    """
    import numpy as np

    if expand <= 0 or a_nnz == 0:
        return None
    for w in (4, 8, 16, 32, 64):
        tail = int(np.maximum(b_referenced_lens - w, 0).sum())
        padded = a_nnz * w + tail
        if padded <= max(2.5 * expand, expand + 4096) and tail <= expand // 4:
            return w, tail
    return None


def _indptr_from_sorted_rows(rows_out, slot_live, n_rows: int):
    # Output slots are (row, col)-ordered, so rows are sorted and the row
    # pointers fall out of a binary search -- no output-sized scatter
    # (searchsorted is rows*log(cap)).
    row_sorted = jnp.where(slot_live, rows_out, n_rows)
    return jnp.searchsorted(
        row_sorted, jnp.arange(n_rows + 1, dtype=INDEX_DTYPE), side="left"
    ).astype(INDEX_DTYPE)


def _pad_or_slice(x, n: int, fill):
    if x.shape[0] >= n:
        return x[:n]
    return jnp.concatenate([x, jnp.full(n - x.shape[0], fill, x.dtype)])


def esc_sort_compress(
    i_key: jax.Array,
    k_key: jax.Array,
    v: jax.Array,
    *,
    n_rows: int,
    n_cols: int,
    out_capacity: int,
    live_capacity: int | None = None,
):
    """Sort partial products by (row, col) and segment-sum duplicates into
    packed CSR arrays -- the shared tail of the single-chip ESC engines and
    the distributed ring kernel's per-shard compress.

    Invalid slots carry ``int32 max`` in BOTH key arrays (they sort last).
    When the output space fits int32 (``n_rows * n_cols < 2**31``) a fused
    key drives one ``sort_key_val``; larger spaces take a lexicographic
    two-int32-key sort with no size limit and no x64.  In the fused regime
    a caller that already holds ``i * n_cols + k`` (big on dead slots) may
    pass it as ``k_key`` with ``i_key=None`` to skip the rebuild passes.

    Compress (v2): instead of rank-scatter compaction (two output-sized
    scatters), duplicates are summed into their run's first slot by a
    ``_DEDUP_STEPS``-deep shifted-add network (handles runs up to
    ``_DEDUP_SPAN``; longer runs --
    detected with one shifted compare -- fall back to the exact scatter
    path under ``lax.cond``), then first occurrences are compacted to the
    front by a second key sort (boundary keys are distinct and already
    relatively ordered, so plain ``sort_key_val`` suffices).

    ``live_capacity`` (static): upper bound on live partials.  When given
    and smaller than ``E``, everything after the first sort is sliced to
    that length -- the windowed expansion pads its input heavily, and the
    first sort parks all padding at the tail, so downstream stages need
    not pay for it.

    Returns ``(indptr, indices, values)`` with row pointers derived by
    binary search over the (row-major sorted) output rows.
    """
    big = jnp.array(jnp.iinfo(jnp.int32).max, jnp.int32)
    E = i_key.shape[0] if i_key is not None else k_key.shape[0]
    fused = n_rows * n_cols < 2**31
    if fused:
        if i_key is None:
            key = k_key  # caller prebuilt the fused key (big on dead slots)
        else:
            key = jnp.where(i_key != big, i_key * n_cols + k_key, big)
        key_sorted, v_sorted = lax.sort_key_val(key, v)
        if live_capacity is not None and live_capacity < E:
            key_sorted = key_sorted[:live_capacity]
            v_sorted = v_sorted[:live_capacity]
        keys = (key_sorted,)
    else:
        i_s, k_s, v_sorted = lax.sort((i_key, k_key, v), dimension=0, num_keys=2)
        if live_capacity is not None and live_capacity < E:
            i_s, k_s, v_sorted = (
                i_s[:live_capacity],
                k_s[:live_capacity],
                v_sorted[:live_capacity],
            )
        keys = (i_s, k_s)
    Es = v_sorted.shape[0]
    if Es == 0:
        zero_i = jnp.zeros(out_capacity, INDEX_DTYPE)
        return (
            jnp.zeros(n_rows + 1, INDEX_DTYPE),
            zero_i,
            jnp.zeros(out_capacity, v.dtype),
        )

    def same_at(shift: int):
        eq = None
        for kk in keys:
            e = kk[shift:] == kk[:-shift]
            eq = e if eq is None else (eq & e)
        return eq

    live = keys[0] != big
    prev_same = jnp.concatenate([jnp.zeros(1, bool), same_at(1)]) if Es > 1 else jnp.zeros(Es, bool)
    boundary = live & ~prev_same
    out_nnz = jnp.sum(boundary, dtype=INDEX_DTYPE)

    def fast_tail(v_sorted):
        # Shifted-add dedup: after step s, slot p holds the sum of its run's
        # values in [p, p + 2**(s+1)); big-key padding slots never alias a
        # live key (live keys < int32 max), so junk sums stay in dead slots.
        vv = v_sorted
        for j in (1 << s for s in range(_DEDUP_STEPS)):
            if j >= Es:
                break
            same = jnp.concatenate([same_at(j), jnp.zeros(j, bool)])
            shifted = jnp.concatenate([vv[j:], jnp.zeros(j, vv.dtype)])
            vv = vv + jnp.where(same, shifted, jnp.zeros((), vv.dtype))
        return vv

    def scatter_tail(v_sorted):
        # Exact path for pathological duplicate runs (> _DEDUP_SPAN): the
        # round-3 rank-scatter.  Sums every run fully; only the run's first
        # slot is read downstream.
        out_idx = jnp.cumsum(boundary, dtype=INDEX_DTYPE) - 1
        cap = max(Es, 1)
        safe_idx = jnp.clip(out_idx, 0, cap - 1)
        summed = (
            jnp.zeros(cap, v_sorted.dtype)
            .at[safe_idx]
            .add(jnp.where(live, v_sorted, 0))
        )
        return summed[out_idx]

    if Es > _DEDUP_SPAN:
        longrun = jnp.any(same_at(_DEDUP_SPAN) & (keys[0][_DEDUP_SPAN:] != big))
        vv = lax.cond(longrun, scatter_tail, fast_tail, v_sorted)
    else:
        vv = fast_tail(v_sorted)

    # Compaction: move each run's first slot to the front, in key order.
    # Boundary keys are distinct, so no stability requirement.
    out_slot = jnp.arange(out_capacity, dtype=INDEX_DTYPE)
    slot_live = out_slot < out_nnz
    if fused:
        key2 = jnp.where(boundary, key_sorted, big)
        key2_s, v2 = lax.sort_key_val(key2, vv)
        key_o = _pad_or_slice(key2_s, out_capacity, jnp.iinfo(jnp.int32).max)
        v_o = _pad_or_slice(v2, out_capacity, 0)
        keys_out = jnp.where(slot_live, key_o, 0)
        rows_out = keys_out // n_cols
        cols_out = keys_out % n_cols
    else:
        i2 = jnp.where(boundary, i_s, big)
        k2 = jnp.where(boundary, k_s, big)
        i2_s, k2_s, v2 = lax.sort((i2, k2, vv), dimension=0, num_keys=2)
        rows_out = jnp.where(slot_live, _pad_or_slice(i2_s, out_capacity, 0), 0)
        cols_out = jnp.where(slot_live, _pad_or_slice(k2_s, out_capacity, 0), 0)
        v_o = _pad_or_slice(v2, out_capacity, 0)
    indices = jnp.where(slot_live, cols_out, 0)
    values = jnp.where(slot_live, v_o, 0)
    indptr = _indptr_from_sorted_rows(
        jnp.where(slot_live, rows_out, 0), slot_live, n_rows
    )
    return indptr, indices, values
