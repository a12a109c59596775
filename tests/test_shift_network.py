"""Property tests for the monotonic shift-network routing primitives.

These are the device replacement for the reference's packed-output
construction and stitch (see ops/shift_network.py docstring); correctness is
checked against direct numpy indexing.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sparse_matrix_mult_tpu.ops.shift_network import (
    compact_1d,
    compact_rows,
    monotonic_move_1d,
    monotonic_move_rows,
)

RNG = np.random.default_rng(1234)


@pytest.mark.parametrize("trial", range(25))
def test_move_1d_random(trial):
    in_len, out_len = 64, 96
    k = int(RNG.integers(0, min(in_len, out_len) + 1))
    dv = np.sort(RNG.choice(out_len, size=k, replace=False))
    ss = np.sort(RNG.choice(in_len, size=k, replace=False))
    valid = np.zeros(in_len, bool)
    valid[ss] = True
    dest = np.zeros(in_len, np.int32)
    dest[ss] = dv
    x = RNG.standard_normal(in_len).astype(np.float32)
    y = RNG.integers(1, 100, in_len).astype(np.int32)

    gx, gy = monotonic_move_1d(
        (jnp.asarray(x), jnp.asarray(y)),
        jnp.asarray(valid),
        jnp.asarray(dest),
        out_len,
    )
    exp_x = np.zeros(out_len, np.float32)
    exp_y = np.zeros(out_len, np.int32)
    exp_x[dv] = x[ss]
    exp_y[dv] = y[ss]
    np.testing.assert_array_equal(np.asarray(gx), exp_x)
    np.testing.assert_array_equal(np.asarray(gy), exp_y)


@pytest.mark.parametrize("trial", range(10))
def test_move_rows_random(trial):
    rows, in_cols, out_cols = 12, 48, 72
    x = RNG.standard_normal((rows, in_cols)).astype(np.float32)
    valid = np.zeros((rows, in_cols), bool)
    dest = np.zeros((rows, in_cols), np.int32)
    exp = np.zeros((rows, out_cols), np.float32)
    for r in range(rows):
        k = int(RNG.integers(0, min(in_cols, out_cols) + 1))
        dv = np.sort(RNG.choice(out_cols, size=k, replace=False))
        ss = np.sort(RNG.choice(in_cols, size=k, replace=False))
        valid[r, ss] = True
        dest[r, ss] = dv
        exp[r, dv] = x[r, ss]
    (got,) = monotonic_move_rows(
        (jnp.asarray(x),), jnp.asarray(valid), jnp.asarray(dest), out_cols
    )
    np.testing.assert_array_equal(np.asarray(got), exp)


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_1d(density):
    in_len = 200
    keep = RNG.random(in_len) < density
    x = RNG.standard_normal(in_len).astype(np.float32)
    (got,) = compact_1d((jnp.asarray(x),), jnp.asarray(keep), in_len)
    exp = np.zeros(in_len, np.float32)
    kept = x[keep]
    exp[: len(kept)] = kept
    np.testing.assert_array_equal(np.asarray(got), exp)


def test_compact_rows_truncates():
    rows, cols, out_cols = 8, 64, 16
    keep = RNG.random((rows, cols)) < 0.3
    x = RNG.standard_normal((rows, cols)).astype(np.float32)
    (got,) = compact_rows((jnp.asarray(x),), jnp.asarray(keep), out_cols)
    exp = np.zeros((rows, out_cols), np.float32)
    for r in range(rows):
        kr = x[r][keep[r]][:out_cols]
        exp[r, : len(kr)] = kr
    np.testing.assert_array_equal(np.asarray(got), exp)
