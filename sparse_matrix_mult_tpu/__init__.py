"""sparse_matrix_mult_tpu: a sparse matrix multiplication framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
vineety/sparse_matrix_mult (CPU/OpenMP/ctypes), providing its five routines

1. sparse x sparse -> sparse CSR
2. sparse x sparse -> dense
3. symmetric (upper-triangle-only) sparse and dense variants
4. fused triple product ``A . B . A^T``

behind the identical public entry point :func:`sparse_matrix_multiply`, plus a
device-resident, jit-composable API (:class:`CSRMatrix`, :func:`multiply`,
:func:`triple_product`) and multi-device execution via ``jax.sharding`` meshes
(:mod:`sparse_matrix_mult_tpu.parallel`).

float64 note: the reference computes strictly in f64
(``/root/reference/include/matrix_def.h:21-23``).  This package enables JAX
x64 at import so scipy round-trips preserve f64, and by default computes in
the operand dtype (see :class:`Precision`).  Set ``SMM_TPU_NO_X64=1`` before
import to opt out.
"""

import os as _os

import jax as _jax

if not _os.environ.get("SMM_TPU_NO_X64"):
    _jax.config.update("jax_enable_x64", True)


def _checkout_cache_dir():
    """``<checkout>/.jax_cache`` when the package runs from a source checkout,
    else ``None``."""
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    if _os.path.exists(_os.path.join(root, "pyproject.toml")):
        return _os.path.join(root, ".jax_cache")
    return None


# Persistent compilation cache: JAX itself reads JAX_COMPILATION_CACHE_DIR;
# only when that is unset does the package keep the cache in its checkout.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = _checkout_cache_dir()
    if _cache_dir:
        _jax.config.update("jax_compilation_cache_dir", _cache_dir)

from ._version import __version__
from .api import get_last_route, multiply, sparse_matrix_multiply, triple_product
from .config import Config, Precision, get_config, set_config
from .types import CSRMatrix, bucket_capacity, from_dense, from_scipy, to_scipy

__all__ = [
    "sparse_matrix_multiply",
    "multiply",
    "triple_product",
    "get_last_route",
    "CSRMatrix",
    "from_scipy",
    "to_scipy",
    "from_dense",
    "bucket_capacity",
    "Config",
    "Precision",
    "get_config",
    "set_config",
    "__version__",
]
