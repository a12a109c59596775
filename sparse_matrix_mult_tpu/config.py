"""Configuration for the sparse-multiply framework.

The reference exposes exactly one tuning knob (``imem_size``, a percent-of-
dense memory heuristic, ``/root/reference/src/sparse_sparse_sparse.cpp:69-80``)
plus the ``OMP_NUM_THREADS`` environment variable.  Here the analogous knobs
are the precision policy, the dense-path size cutoff, the host/device
routing model, and the ESC engines' dispatch budgets.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["Config", "get_config", "set_config", "Precision"]


class Precision:
    """Compute-precision policies, identical on every backend.

    * ``AUTO``     -- the default: compute in the operand dtype (float64
      through the scipy entry point) with ``precision='highest'``.  Exact
      parity with scipy's float64 products.
    * ``STRICT``   -- the same as ``AUTO``: operand dtype at ``'highest'``.
    * ``FAST``     -- float32 operands and a float32 product at
      ``precision='highest'`` (full float32, no TF32).  Explicit request
      only.
    * ``SPLIT``    -- double-float (hi/lo) operand split, three float32
      products recombined in float64.  Removes input-rounding error;
      accumulation error stays ~sqrt(K)*eps_f32.  Explicit request only.
    """

    FAST = "fast"
    SPLIT = "split"
    STRICT = "strict"
    AUTO = "auto"


@dataclasses.dataclass
class Config:
    # Precision policy (see Precision); AUTO computes in the operand dtype.
    precision: str = Precision.AUTO
    # Dense fast path is used when rows*cols of every involved matrix is at
    # most this many elements (f32 bytes = 4x this).  1 GiB of f32 by default.
    dense_path_limit: int = 1 << 28
    # Below this many output elements, the DENSE-route sparse-output
    # extraction happens on host (download the small dense product, pack
    # with scipy's C code) instead of on device.  Not measured on the H100.
    host_extract_limit: int = 1 << 22
    # At or below this many partial products the scipy-in/scipy-out API
    # computes on the HOST via the native OpenMP Gustavson kernel
    # (utils/native.py spgemm_host): a device dispatch alone costs more
    # wall time than the whole multiply down here (the reference makes the
    # same call about its serial mode vs MKL, README.md:16-17).  Device-
    # native entry points (multiply, spgemm_*) never route to host.
    host_compute_limit: int = 1 << 19
    # Host-vs-device cost model for the scipy-in/scipy-out API (above the
    # hard limit): route to host when
    #   partials / host_rate  <  link_fixed_s + up_bytes / link_up_bytes_per_s
    #                            + down_bytes / link_down_bytes_per_s,
    # with host_rate = host_rate_base * sqrt(reuse) where reuse =
    # partials / output-slots models SPA cache amortization.  The link
    # defaults model a PCIe-attached accelerator, the two directions
    # separately; the auto-calibration below replaces them with measured
    # values.  Not measured on the H100.
    host_rate_base: float = 5e7
    link_fixed_s: float = 2e-3
    link_up_bytes_per_s: float = 8e9
    link_down_bytes_per_s: float = 8e9
    # Host dense->CSR pack rate (elements/s) for the dense-panel download
    # route (native OpenMP kernel, utils/native.py dense_pack).
    host_pack_rate: float = 2.5e7
    # Measure the real dispatch latency and transfer bandwidths once, at
    # the first routing decision, and overwrite the three link_* fields.
    # Costs one trivial dispatch and one ~2 MB transfer each way, once per
    # process.  Disable for fully deterministic routing.
    auto_calibrate_link: bool = True
    # Target partial products per ESC dispatch.  The chunked large-sparse
    # path sizes its flop-balanced row chunks against this; a single row
    # whose flop count exceeds it still runs in ONE dispatch with a larger
    # (actual-size) capacity, so termination never depends on this value.
    esc_expand_limit: int = 1 << 22
    # Row-binned 2D ESC engine (ops/spgemm_binned.py): per-lane sort width
    # and ELLPACK slice window.  The engine is preferred whenever its host
    # planner finds a layout within its padding budget, falling back to
    # windowed/classic ESC.  Defaults not measured on the H100.
    use_binned_esc: bool = True
    binned_lane_width: int = 4096
    binned_window: int = 8
    # Single-dispatch budget for the binned engine (partial products).
    # Its live set is ~6 buffers of the padded lane volume (<= 3x the
    # expansion, planner-enforced), so 32M partials is ~2.3 GB of device
    # memory and 8x the 1D engines' dispatch budget.  Scaled by the same
    # imem_size hint as esc_expand_limit.  Not measured on the H100.
    binned_expand_limit: int = 1 << 25
    # Emit the reference's "Multiplication resulted in a zero matrix." notice
    # (/root/reference/sparse_matrix_mult/matrix_ops.py:370-373).
    zero_result_notice: bool = True
    # Structural-zero contract for SPARSE outputs.  The reference's
    # Gustavson workers keep every TOUCHED entry, including ones whose
    # accumulated value is exactly 0 (/root/reference/src/sparsework.cpp:
    # 73-110); modern scipy (>= 1.14) prunes them in matmul.  Routes here:
    # native-host Gustavson and ESC keep Gustavson structure; the scipy
    # small-problem host branch and dense extraction prune.  With
    # keep_structure=True the sparse-output router uses only the
    # Gustavson-structure strategies (native host kernel at every size,
    # ESC, chunked ESC), so nnz patterns match the reference exactly for
    # cancellation-prone inputs -- at a performance cost for dense-ish
    # products.
    keep_structure: bool = False
    # Default mesh axis name for distributed SpGEMM.
    mesh_axis: str = "rows"
    # Per-device dense working-set budget for the distributed layer: when a
    # shard's dense row panel (rows_pad x n x itemsize, A-panel + B-panel +
    # C-panel) would exceed this, spgemm_csr_distributed auto-dispatches to
    # the sparse local contraction (spgemm_csr_distributed_sparse) instead
    # of densifying per shard.  4 GiB default; not measured on the H100.
    dense_shard_budget_bytes: int = 4 << 30
    # Force the pure-jnp fallback everywhere (debugging).
    force_reference_path: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_config = Config()

if os.environ.get("SMM_TPU_PRECISION"):
    _config.precision = os.environ["SMM_TPU_PRECISION"]


def get_config() -> Config:
    return _config


def set_config(cfg: Optional[Config] = None, **kw) -> Config:
    global _config
    if cfg is not None:
        _config = cfg
    if kw:
        _config = _config.replace(**kw)
    return _config
