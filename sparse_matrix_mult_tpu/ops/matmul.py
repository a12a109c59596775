"""Precision-policy dense matmuls.

The reference computes strictly in float64 on CPU
(``/root/reference/include/matrix_def.h:21-23``).  These helpers run a
product under one of the policies of
:class:`sparse_matrix_mult_tpu.config.Precision`; the policy means the
same on every backend, and every product states its precision.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Precision, get_config

__all__ = ["policy_matmul", "split_operand", "resolve_precision", "policy_dtype"]

_POLICIES = (Precision.FAST, Precision.SPLIT, Precision.STRICT)


def resolve_precision(precision: str | None = None) -> str:
    """Concrete policy for a request (``None`` reads :attr:`Config.precision`).

    ``AUTO`` resolves to ``STRICT``: the operand dtype at
    ``precision='highest'``.  ``FAST`` and ``SPLIT`` only ever come from
    an explicit request.
    """
    p = precision or get_config().precision
    if p == Precision.AUTO:
        return Precision.STRICT
    if p not in _POLICIES:
        raise ValueError(f"unknown precision policy: {p!r}")
    return p


def policy_dtype(precision: str | None = None):
    """Operand dtype a policy computes in: float32 under FAST, else ``None``
    (keep the operand dtype)."""
    return jnp.float32 if resolve_precision(precision) == Precision.FAST else None


def split_operand(x: jax.Array):
    """Double-float split: ``x ~= hi + lo`` with both parts exactly f32."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return hi, lo


def _dot(a, b):
    return jnp.dot(a, b, precision="highest")


def policy_matmul(
    a: jax.Array,
    b: jax.Array,
    precision: str | None = None,
    out_dtype=None,
    matmul=None,
) -> jax.Array:
    """``a @ b`` under a precision policy.

    ``matmul`` is the product used for every term (``a @ b`` at
    ``precision='highest'`` by default; the triangular product passes its
    own), so a policy composes with any product of the same contract.
    """
    prec = resolve_precision(precision)
    matmul = matmul or _dot
    if out_dtype is None:
        out_dtype = jnp.result_type(a.dtype, b.dtype)

    if prec == Precision.STRICT:
        return matmul(a, b).astype(out_dtype)

    if prec == Precision.FAST:
        return matmul(a.astype(jnp.float32), b.astype(jnp.float32)).astype(out_dtype)

    # SPLIT: three f32 products of the hi/lo parts, recombined wide.
    ahi, alo = split_operand(a)
    bhi, blo = split_operand(b)
    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    hh = matmul(ahi, bhi).astype(acc)
    cross = matmul(ahi, blo).astype(acc) + matmul(alo, bhi).astype(acc)
    return (hh + cross).astype(out_dtype)
