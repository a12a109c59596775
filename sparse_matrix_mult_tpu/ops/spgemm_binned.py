"""Row-binned 2D ESC: the round-5 hypersparse SpGEMM engine.

The round-4 windowed engine (:func:`.spgemm_jnp.spgemm_esc_windowed`) spends
its time in 1D device-wide passes: two 1D sorts, a cummax tail expansion
and an indptr ``searchsorted``.  This engine replaces them with 2D per-row
sorts of the same volume and a ``lax.scan`` stitch of a few hundred lane
rows (the engines have not been timed against each other on the H100):

1. **Sliced ELLPACK table** (host-planned): every B row is cut into
   ``ceil(len/W)`` width-``W`` slices; a ``(S+1, 1+2W)`` device table
   ``[len | cols | value-bits]`` is built with ONE windowed gather, then
   each virtual entry row-gathers its slice from the table.  Long B rows
   need no tail machinery -- they just own more slices.  (A one-level
   ``lax.gather`` with ``slice_sizes=(W, 2)`` looks cheaper on paper but
   lowers to per-block serialized DMA on this backend: 450 ms vs 3.4 ms
   at 456k blocks -- benchmarks/profile_binned_parts.py.)
2. **Virtual A entries** (host-planned): an A entry whose B row has ``n``
   slices becomes ``n`` virtual entries, laid out in a ``(G, P/W)`` grid
   where each lane row ``g`` holds WHOLE output rows (a contiguous global
   row range).
3. **Lane-local sort/dedup/compact**: partials of an output row never
   leave their lane row, so the (row, col) sort, the shifted-add dedup
   and the compaction sort all run as 2D ``dimension=1`` ops.  The dedup
   network runs to full lane depth (``ceil(log2 P)`` shifted adds --
   marginal cost ~0, the passes fuse), so ANY duplicate-run length is
   summed exactly with no data-dependent fallback branch (the round-5a
   6-step + ``lax.cond`` long-run probe cost several ms of un-fusable
   reduction and an extra code path).
4. **Lane-local indptr**: every output row lives in exactly one lane
   (``plan.row_lane``), so ``indptr`` is a ``ceil(log2 P)``-step batched
   lower-bound search over the compact-sorted lane keys and never touches
   the output-scale stitched buffer.
5. **Scan stitch**: ``G`` dynamic-update-slices pack the per-lane packed
   runs into the final CSR arrays (forward overwrite of each run's padded
   tail).  Only the column/key plane and
   the values are stitched -- the row plane never leaves 2D.

Replaces the same reference hot loop as the other ESC engines
(``/root/reference/src/sparsework.cpp:56-129``): where the reference
re-partitions rows across OpenMP threads, the host planner here packs rows
into VPU-friendly lanes.  Planning is O(nnz) numpy, done once per operand
STRUCTURE -- the production shape (the reference's motivating inversion
workload holds H and Q structure fixed, ``/root/reference/README.md:140``)
pays it once and reuses the plan across every multiply.

Benchmarking note (hard-won): never time this engine with operands or
plan arrays closed over the jitted callable -- XLA treats captured
arrays as compile-time constants and can lower (or fold) stages
differently, under-reporting by an order of magnitude.  Pass everything
as arguments, as the API does (benchmarks/profile_binned_parts.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..types import CSRMatrix, INDEX_DTYPE

__all__ = ["BinnedPlan", "binned_plan", "spgemm_esc_binned"]


@dataclasses.dataclass(frozen=True)
class BinnedPlan:
    """Host-side structure plan for :func:`spgemm_esc_binned`.

    All arrays are numpy (uploaded implicitly at call time, or pre-place
    them with ``jnp.asarray`` once for repeated products):

    * ``slice_start``/``slice_len`` -- (S+1,) int32 positions into B's
      entry arrays; slice ``S`` is a dummy empty slice for dead slots.
    * ``va_slice``/``va_entry``/``va_row`` -- (G, P/W) int32 virtual-entry
      grid: slice id, A entry index, global output row (dead slots point
      at the dummy slice).
    * ``row_lane`` -- (n_rows,) int32 lane holding each output row (rows
      are contiguous per lane).
    * ``window`` (W), ``lane_width`` (P) -- static tile parameters.
    * ``n_partials`` -- exact live partial-product count (for capacity
      sizing); ``padded`` = G * P total slots.
    * ``max_run`` -- proven bound on any duplicate-(row, col) run length:
      an A entry (i, j) contributes at most ONE partial to output column
      k, so a run for row i never exceeds nnz(A[i, :]).  The engine sizes
      its shifted-add dedup network to ``ceil(log2 max_run)`` passes --
      exact by construction, no data-dependent fallback.
    """

    slice_start: np.ndarray
    slice_len: np.ndarray
    va_slice: np.ndarray
    va_entry: np.ndarray
    va_row: np.ndarray
    row_lane: np.ndarray
    window: int
    lane_width: int
    n_partials: int
    max_run: int = 1 << 30  # conservative default: full-lane depth

    @property
    def padded(self) -> int:
        return self.va_slice.shape[0] * self.va_slice.shape[1] * self.window

    # kept for shape introspection parity with older call sites
    @property
    def va_start(self) -> np.ndarray:
        return self.slice_start[self.va_slice]

    @property
    def va_len(self) -> np.ndarray:
        """(G, P/W) per-virtual-entry slice length, host-derived.

        Shipping this instead of a length column in the device slice
        table keeps the table a power-of-2 row width (2W), which the
        row gather wants (a 17-wide table row is misaligned)."""
        return self.slice_len[self.va_slice]

    def device_args(self):
        """The positional device arrays for :func:`spgemm_esc_binned`."""
        return (
            jnp.asarray(self.slice_start),
            jnp.asarray(self.va_slice),
            jnp.asarray(self.va_len),
            jnp.asarray(self.va_entry),
            jnp.asarray(self.va_row),
            jnp.asarray(self.row_lane),
        )


def binned_plan(
    a_indptr,
    a_indices,
    b_indptr,
    *,
    window: int = 8,
    lane_width: int = 4096,
    max_pad_ratio: float = 3.0,
):
    """Build a :class:`BinnedPlan` for ``A @ B`` from host CSR structure.

    Returns ``None`` when the layout degenerates: a single output row's
    padded volume exceeds one lane (``lane_width``), or total padding
    exceeds ``max_pad_ratio`` x the exact expansion (callers then fall
    back to the windowed/classic engines).  O(nnz(A) + nnz(B)) numpy.
    """
    W = int(window)
    P = int(lane_width)
    Wp = P // W
    a_indptr = np.asarray(a_indptr, np.int64)
    a_indices = np.asarray(a_indices, np.int64)
    b_indptr = np.asarray(b_indptr, np.int64)
    n_rows = len(a_indptr) - 1
    a_nnz = int(a_indptr[-1])

    b_len = np.diff(b_indptr)
    nsl = -(-b_len // W)  # slices per B row
    S = int(nsl.sum())
    scum = np.concatenate([[0], np.cumsum(nsl)])

    # Virtual-entry counts per A entry / per output row.
    per_entry = nsl[a_indices[:a_nnz]]
    ecum = np.concatenate([[0], np.cumsum(per_entry)])
    V = int(ecum[-1])
    n_partials = int((b_len[a_indices[:a_nnz]]).sum())
    if V == 0 or n_partials == 0:
        return None
    vrow_cum = ecum[a_indptr]  # (n_rows+1,) virtual entries before each row
    vcnt = np.diff(vrow_cum)
    if int(vcnt.max()) > Wp:
        return None  # a single output row overflows one lane
    # Contiguous-row first-fit binning: close the lane when the next row
    # would overflow P padded slots.  Rows stay in global order, so the
    # stitched output is row-major CSR with no extra permutation.  One
    # searchsorted per LANE (a few thousand) instead of a Python loop per
    # ROW (vcnt.max() <= Wp is guaranteed above, so every lane advances).
    r0 = [0]
    while r0[-1] < n_rows:
        start = r0[-1]
        stop = int(
            np.searchsorted(vrow_cum, vrow_cum[start] + Wp, side="right") - 1
        )
        r0.append(min(max(stop, start + 1), n_rows))
    r0 = np.asarray(r0, np.int64)
    G = len(r0) - 1
    if G * P > max_pad_ratio * max(n_partials, 1) + P:
        return None
    row_lane = np.repeat(np.arange(G), np.diff(r0)).astype(np.int32)

    # Slice table: position/length of every B-row slice.
    srow = np.repeat(np.arange(len(b_len)), nsl)
    within = np.arange(S) - scum[srow]
    slice_start = np.concatenate(
        [(b_indptr[srow] + within * W), [0]]
    ).astype(np.int32)
    slice_len = np.concatenate(
        [np.minimum(b_len[srow] - within * W, W), [0]]
    ).astype(np.int32)

    # Virtual-entry grid, filled by one flat scatter (rows are contiguous
    # per bin, so a bin's virtual entries are the contiguous id range
    # [vrow_cum[r0[g]], vrow_cum[r0[g+1]]) laid at the bin's slot base).
    ve_entry = np.repeat(np.arange(a_nnz), per_entry)
    ve_within = np.arange(V) - ecum[ve_entry]
    ve_slice = scum[a_indices[ve_entry]] + ve_within
    row_of_entry = np.repeat(np.arange(n_rows), np.diff(a_indptr))
    ve_row = row_of_entry[ve_entry]

    bin_first_ve = vrow_cum[r0]  # (G+1,)
    bin_of_ve = np.searchsorted(bin_first_ve, np.arange(V), side="right") - 1
    slot = np.arange(V) - bin_first_ve[bin_of_ve]
    flat = bin_of_ve * Wp + slot

    va_slice = np.full(G * Wp, S, np.int32)
    va_entry = np.zeros(G * Wp, np.int32)
    va_row = np.zeros(G * Wp, np.int32)
    va_slice[flat] = ve_slice
    va_entry[flat] = ve_entry
    va_row[flat] = ve_row
    a_row_nnz = np.diff(a_indptr)
    return BinnedPlan(
        slice_start=slice_start,
        slice_len=slice_len,
        va_slice=va_slice.reshape(G, Wp),
        va_entry=va_entry.reshape(G, Wp),
        va_row=va_row.reshape(G, Wp),
        row_lane=row_lane,
        window=W,
        lane_width=P,
        n_partials=n_partials,
        max_run=int(a_row_nnz.max()) if len(a_row_nnz) else 1,
    )


@functools.partial(
    jax.jit,
    static_argnames=("window", "out_capacity", "symmetric", "dedup_span"),
)
def spgemm_esc_binned(
    a: CSRMatrix,
    b: CSRMatrix,
    slice_start: jax.Array,
    va_slice: jax.Array,
    va_len: jax.Array,
    va_entry: jax.Array,
    va_row: jax.Array,
    row_lane: jax.Array,
    *,
    window: int,
    out_capacity: int,
    symmetric: bool = False,
    row_offset=0,
    dedup_span: int = 0,
) -> CSRMatrix:
    """``C = A @ B`` via the row-binned 2D ESC pipeline (see module doc).

    The plan arrays come from :func:`binned_plan` built against the SAME
    host structure the device operands were uploaded from (entry order
    must match; ``from_scipy`` preserves it) -- pass
    ``*plan.device_args()``.  ``va_row`` carries LOCAL row ids when A is
    a row chunk; ``row_offset`` keeps the symmetric filter globally
    correct, as in the other ESC engines.
    """
    rows, _ = a.shape
    _, cols = b.shape
    W = int(window)
    G, Wp = va_slice.shape
    P = Wp * W
    big = jnp.array(jnp.iinfo(jnp.int32).max, jnp.int32)
    off = jnp.asarray(row_offset, INDEX_DTYPE)
    fused = rows * cols < 2**31

    wr = jnp.arange(W, dtype=INDEX_DTYPE)
    # Slice-table build via ALIGNED block pairs: a slice starting at s
    # spans blocks s//W and s//W+1 of a W-blocked view of B's entries, so
    # one (S+1, 2)-row gather of 2W-wide aligned rows plus a W-way masked
    # shift select replaces the (S+1, W) element gather: row gathers of a
    # handful of columns cost about one column's element gather.
    nblk = -(-b.capacity // W) + 1
    pad = nblk * W - b.capacity
    f32 = a.values.dtype == jnp.float32 and b.values.dtype == jnp.float32
    q = slice_start // W
    r = slice_start - q * W  # in [0, W)
    pq = jnp.stack([q, q + 1], axis=1)  # (S+1, 2) block ids

    def pair_select(pair, r_):
        # pair: (S+1, 2W) = two adjacent aligned blocks; select the
        # W-window at offset r via a W-way masked accumulate (VPU-only).
        out = jnp.zeros((pair.shape[0], W), pair.dtype)
        for s in range(W):
            out = out + jnp.where(
                (r_ == s)[:, None], pair[:, s : s + W], jnp.zeros((), pair.dtype)
            )
        return out

    if f32:
        bi = jnp.concatenate([b.indices, jnp.zeros(pad, INDEX_DTYPE)])
        bvb = jnp.concatenate(
            [lax.bitcast_convert_type(b.values, jnp.int32), jnp.zeros(pad, jnp.int32)]
        )
        blocks = jnp.concatenate(
            [bi.reshape(nblk, W), bvb.reshape(nblk, W)], axis=1
        )  # (nblk, 2W): [cols | value-bits] of one aligned block
        gp = blocks[jnp.clip(pq, 0, nblk - 1)]  # (S+1, 2, 2W)
        tbl_c = pair_select(
            jnp.concatenate([gp[:, 0, :W], gp[:, 1, :W]], axis=1), r
        )
        tbl_v = pair_select(
            jnp.concatenate([gp[:, 0, W:], gp[:, 1, W:]], axis=1), r
        )
        tbl = jnp.concatenate([tbl_c, tbl_v], axis=1)  # (S+1, 2W) aligned
        ga = tbl[va_slice.reshape(-1)].reshape(G, Wp, 2 * W)
        k2 = ga[:, :, :W]
        bv = lax.bitcast_convert_type(ga[:, :, W:], jnp.float32)
    else:
        bi = jnp.concatenate([b.indices, jnp.zeros(pad, INDEX_DTYPE)])
        bvp = jnp.concatenate([b.values, jnp.zeros(pad, b.values.dtype)])
        gi = bi.reshape(nblk, W)[jnp.clip(pq, 0, nblk - 1)]  # (S+1, 2, W)
        gv = bvp.reshape(nblk, W)[jnp.clip(pq, 0, nblk - 1)]
        tbl_c = pair_select(gi.reshape(-1, 2 * W), r)
        tbl_v = pair_select(gv.reshape(-1, 2 * W), r)
        vs = va_slice.reshape(-1)
        k2 = tbl_c[vs].reshape(G, Wp, W)
        bv = tbl_v[vs].reshape(G, Wp, W)
    ln = va_len
    # a-value fetch as an (N, 2) row gather (row gathers cost about one
    # column regardless of width).
    a_pack = jnp.stack([a.values, a.values], axis=1)
    av = a_pack[va_entry][..., 0]  # (G, Wp) gather at virtual-entry scale
    v2 = av[..., None] * bv
    i2 = jnp.broadcast_to(va_row[..., None], (G, Wp, W)).astype(INDEX_DTYPE)
    valid = wr[None, None, :] < ln[..., None]
    if symmetric:
        valid = valid & (k2 >= i2 + off)
    vals = v2.reshape(G, P)

    if fused:
        keys = jnp.where(valid, i2 * cols + k2, big).reshape(G, P)
        keys_s, vals_s = lax.sort_key_val(keys, vals, dimension=1)
        keyset = (keys_s,)
    else:
        ik = jnp.where(valid, i2, big).reshape(G, P)
        kk = jnp.where(valid, k2, big).reshape(G, P)
        i_s, k_s, vals_s = lax.sort((ik, kk, vals), dimension=1, num_keys=2)
        keyset = (i_s, k_s)

    def same_at(j: int):
        eq = None
        for kkk in keyset:
            e = kkk[:, j:] == kkk[:, :-j]
            eq = e if eq is None else (eq & e)
        return eq

    live = keyset[0] != big
    zcol = jnp.zeros((G, 1), bool)
    prev_same = jnp.concatenate([zcol, same_at(1)], axis=1) if P > 1 else jnp.zeros((G, P), bool)
    boundary = live & ~prev_same

    # Shifted-add dedup: lane-local segmented suffix sum.  Runs never
    # cross lane rows and (see BinnedPlan.max_run) never exceed the max
    # nnz of an A row, so ceil(log2 min(max_run, P)) passes sum every
    # duplicate run exactly -- no data-dependent branch, no scatter
    # fallback.  ``dedup_span=0`` (the default) runs full lane depth.
    span = P
    if dedup_span:
        span = 1
        while span < min(int(dedup_span), P):
            span <<= 1
    vv = vals_s
    j = 1
    while j < span:
        same = jnp.concatenate([same_at(j), jnp.zeros((G, j), bool)], axis=1)
        shifted = jnp.concatenate([vv[:, j:], jnp.zeros((G, j), vv.dtype)], axis=1)
        vv = vv + jnp.where(same, shifted, jnp.zeros((), vv.dtype))
        j <<= 1

    # Lane-local compaction: run-first slots to the front of each lane.
    if fused:
        key2 = jnp.where(boundary, keys_s, big)
        key2_s, v2s = lax.sort_key_val(key2, vv, dimension=1)
        search_plane = key2_s
        col_plane = None
    else:
        i2c = jnp.where(boundary, i_s, big)
        k2c = jnp.where(boundary, k_s, big)
        i2_s, k2_s, v2s = lax.sort((i2c, k2c, vv), dimension=1, num_keys=2)
        search_plane = i2_s
        col_plane = k2_s
    cnt = jnp.sum(boundary, axis=1, dtype=INDEX_DTYPE)
    offs = jnp.concatenate(
        [jnp.zeros(1, INDEX_DTYPE), jnp.cumsum(cnt, dtype=INDEX_DTYPE)]
    )
    out_nnz = offs[-1]

    # Lane-local indptr: every output row lives in exactly one lane and
    # lanes hold ascending row ranges, so indptr[r] = offs[row_lane[r]] +
    # lower_bound(lane keys, first key of row r).  A ceil(log2 P)-step
    # batched binary search over (n_rows,) queries -- replaces the
    # output-scale searchsorted and its OC-sized row-extraction feed.
    lane = row_lane.astype(INDEX_DTYPE)
    base = lane * P
    if fused:
        q = jnp.arange(rows, dtype=INDEX_DTYPE) * cols
    else:
        q = jnp.arange(rows, dtype=INDEX_DTYPE)
    flat_keys = search_plane.reshape(-1)
    lo = jnp.zeros(rows, INDEX_DTYPE)
    step = 1
    while step < P:
        step <<= 1
    # step = smallest power of two >= P; the first (gated) probe lets
    # ``lo`` reach P itself -- a full lane followed by an empty row needs
    # lower_bound = P, which a P/2 start could never produce.
    while step >= 1:
        probe = lo + step
        idx = jnp.clip(base + probe - 1, 0, G * P - 1)
        kv = flat_keys[idx]
        lo = jnp.where((probe <= P) & (kv < q), probe, lo)
        step >>= 1
    indptr = jnp.concatenate([offs[lane] + lo, out_nnz[None]]).astype(INDEX_DTYPE)

    # Scan stitch: pack lane runs head-to-tail.  Each DUS writes a full
    # P-wide lane; the dead tail beyond cnt[g] is overwritten by lane
    # g+1's write (offs[g+1] = offs[g] + cnt[g]), and the final tail
    # lands in the +P slack past out_nnz, masked below.  Only the column
    # plane (or the fused key plane) and values are stitched -- indptr
    # comes from the lanes above, so the row plane never leaves 2D.
    OC = int(out_capacity)
    planes = ((key2_s if fused else col_plane), v2s)
    bufs0 = (
        jnp.full(OC + P, big, jnp.int32),
        jnp.zeros(OC + P, vals.dtype),
    )

    def step_fn(carry, xs):
        *lanes_x, o = xs
        out = tuple(
            lax.dynamic_update_slice(buf, lane_row, (o,))
            for buf, lane_row in zip(carry, lanes_x)
        )
        return out, None

    # unroll: the per-step cost is ~all loop scheduling overhead (a lane's
    # 32KB DUS write is ~2 us of HBM time); unrolling 8 bodies per step
    # cuts the overhead ~4x at G in the hundreds-to-thousands.
    bufs, _ = lax.scan(step_fn, bufs0, (*planes, offs[:-1]), unroll=8)
    slot = jnp.arange(OC, dtype=INDEX_DTYPE)
    slot_live = slot < out_nnz
    if fused:
        keys_o = jnp.where(slot_live, bufs[0][:OC], 0)
        cols_out = keys_o % cols
    else:
        cols_out = jnp.where(slot_live, bufs[0][:OC], 0)
    indices = cols_out.astype(INDEX_DTYPE)
    values = jnp.where(slot_live, bufs[1][:OC], 0)
    return CSRMatrix(indptr=indptr, indices=indices, values=values, shape=(rows, cols))
