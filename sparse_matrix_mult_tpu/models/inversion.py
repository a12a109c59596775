"""Linear (Bayesian) inverse-problem workflow built on the framework.

This is the motivating application of the reference package: quadratic
products of covariance matrices in *linear atmospheric inverse problems*
(``/root/reference/README.md:5`` and the companion paper Yadav & Michalak,
GMD 2016, ``/root/reference/README.md:140``).  The reference ships only the
kernel (``triple_product``); users assemble the inversion by hand.  Here the
full batch-inversion step is provided as a jit-compiled device pipeline:

Given observations ``y = H x + eps`` with sparse Jacobian H (n_obs x n_state),
prior covariance Q (sparse, n_state x n_state), prior mean ``x0`` and
observation noise covariance R (diagonal, n_obs):

* ``HQHt = H . Q . H^T``          -- the fused triple product (never
  materializes H.Q), mirrored to full for the solve.
* ``S = HQHt + R``                 -- innovation covariance.
* ``K^T = solve(S, H Q)``          -- Cholesky solve on the device.
* ``x_post = x0 + (Q H^T) S^{-1} (y - H x0)``
* ``P_diag = diag(Q) - rowsum((Q H^T) * K^T^T)`` -- posterior marginal
  variances without forming the full posterior covariance.

Everything after the sparse triple product is dense n_obs-sized work, which
is the regime these inversions run in (n_obs << n_state).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.convert import csr_to_dense
from ..ops.triple_product import triple_product_dense
from ..types import CSRMatrix

__all__ = ["InversionResult", "invert", "posterior_covariance"]


class InversionResult(NamedTuple):
    x_post: jax.Array  # (n_state,) posterior mean
    p_diag: jax.Array  # (n_state,) posterior marginal variances
    innovation: jax.Array  # (n_obs,) y - H x0
    s: jax.Array  # (n_obs, n_obs) innovation covariance (HQH^T + R)


def _dense_ops(h: CSRMatrix, q: CSRMatrix):
    return csr_to_dense(h), csr_to_dense(q)


@jax.jit
def invert(
    h: CSRMatrix,
    q: CSRMatrix,
    y: jax.Array,
    x0: jax.Array,
    r_diag: jax.Array,
) -> InversionResult:
    """One batch linear-inversion step (posterior mean + marginal variances).

    ``h`` is the (n_obs, n_state) sparse Jacobian, ``q`` the (n_state,
    n_state) sparse prior covariance, ``r_diag`` the diagonal observation
    noise.  jit-composable; all heavy lifting is dense matmuls plus the fused
    sparse triple product.
    """
    n_obs, n_state = h.shape
    hd, qd = _dense_ops(h, q)
    dt = hd.dtype

    # Innovation covariance via the fused triple product (upper + mirror).
    hqht = triple_product_dense(h, q, compute_full_matrix=1)
    s = hqht.astype(dt) + jnp.diag(r_diag.astype(dt))

    qht = jnp.dot(qd, hd.T, precision="highest")  # (n_state, n_obs)
    innov = y.astype(dt) - jnp.dot(hd, x0.astype(dt), precision="highest")

    chol = jax.scipy.linalg.cho_factor(s)
    x_post = x0.astype(dt) + jnp.dot(
        qht, jax.scipy.linalg.cho_solve(chol, innov), precision="highest"
    )

    # Posterior marginal variances: diag(Q - Q H^T S^-1 H Q).
    kt = jax.scipy.linalg.cho_solve(chol, qht.T)  # (n_obs, n_state)
    q_diag = jnp.diagonal(qd)
    p_diag = q_diag - jnp.sum(qht * kt.T, axis=1)

    return InversionResult(
        x_post=x_post, p_diag=p_diag, innovation=innov, s=s
    )


@functools.partial(jax.jit, static_argnames=())
def posterior_covariance(h: CSRMatrix, q: CSRMatrix, r_diag: jax.Array):
    """Full posterior covariance ``Q - Q H^T (HQH^T + R)^{-1} H Q``.

    Materializes the (n_state, n_state) result; use :func:`invert` when only
    marginal variances are needed.
    """
    hd, qd = _dense_ops(h, q)
    dt = hd.dtype
    hqht = triple_product_dense(h, q, compute_full_matrix=1)
    s = hqht.astype(dt) + jnp.diag(r_diag.astype(dt))
    qht = jnp.dot(qd, hd.T, precision="highest")
    chol = jax.scipy.linalg.cho_factor(s)
    kt = jax.scipy.linalg.cho_solve(chol, qht.T)
    return qd - jnp.dot(qht, kt, precision="highest")
