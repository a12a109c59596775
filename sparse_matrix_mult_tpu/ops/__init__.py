"""Compute kernels: dense fast path, expansion-sort SpGEMM, triple product,
precision-policy matmuls, and the upper-triangular product."""

from .dense_path import spgemm_dense_out, spgemm_sparse_out
from .matmul import policy_matmul
from .spgemm_binned import binned_plan, spgemm_esc_binned
from .spgemm_jnp import (
    expansion_size,
    precompute_window_table,
    spgemm_esc,
    spgemm_esc_windowed,
    windowed_plan,
)
from .triple_product import triple_product_dense
from .triu_matmul import matmul_triu

__all__ = [
    "spgemm_dense_out",
    "spgemm_sparse_out",
    "spgemm_esc",
    "spgemm_esc_windowed",
    "spgemm_esc_binned",
    "binned_plan",
    "precompute_window_table",
    "windowed_plan",
    "expansion_size",
    "triple_product_dense",
    "policy_matmul",
    "matmul_triu",
]
