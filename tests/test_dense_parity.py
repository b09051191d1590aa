"""Dense sandwich / matvec / transpose-matvec parity against numpy.

The shapes and adversarial inputs (wide dynamic range, zero columns,
signed and zero weights, full-mantissa values, very long contractions)
hold the plain XLA routes to numpy references.

Accuracy metric for sandwiches: error scaled by sqrt(S_ii·S_jj), the
natural column scale — elementwise relative error is not meaningful for
entries that cancel, and plain f64 accumulation has the same property.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import tabmat_tpu as tm
from tabmat_tpu.ops import dense_ops

# long-contraction row counts: a 1024-row block, and multiples past it
BT = 1024
SANDWICH_SHAPES = [
    (1000, 5), (20_000, 40), (4097, 1),          # odd n, long contraction
    (5000, 50), (3001, 7), (4096, 128), (999, 3),
    (BT, 4), (2 * BT + 384, 7), (BT + 128, 50), (BT, 100), (3 * BT + 777, 3),
    (2048, 3), (5000, 1), (3000, 10), (2048, 33),  # narrow designs
    (50_000, 20),                                  # n far past 16k rows
]
TMV_SHAPES = [(5000, 50), (3001, 7), (4096, 128), (999, 3), (1000, 5), (20_000, 40),
              (50_000, 20)]


def _scaled_err(out, ref, scale_ref=None):
    diag = np.sqrt(np.abs(np.diag(ref if scale_ref is None else scale_ref)) + 1e-300)
    return (np.abs(np.asarray(out) - ref) / (diag[:, None] * diag[None, :])).max()


def _relerr(out, ref):
    return np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("n,k", SANDWICH_SHAPES)
def test_sandwich_matches_numpy(n, k):
    rng = np.random.default_rng(n + k)
    X = rng.standard_normal((n, k)) * np.exp2(rng.uniform(-8, 8, (1, k)))
    d = rng.uniform(0.1, 10.0, n) * np.exp2(rng.uniform(-4, 4, n))
    got = tm.DenseMatrix(X).sandwich(d)
    assert _scaled_err(got, (X.T * d) @ X) < 1e-13


@pytest.mark.parametrize("n,k", TMV_SHAPES)
def test_transpose_matvec_matches_numpy(n, k):
    rng = np.random.default_rng(2 * n + k)
    X = rng.standard_normal((n, k)) * np.exp2(rng.uniform(-8, 8, (1, k)))
    r = rng.standard_normal(n) * np.exp2(rng.uniform(-4, 4, n))
    got = tm.DenseMatrix(X).transpose_matvec(jnp.asarray(r))
    scale = np.abs(X.T) @ np.abs(r)
    assert (np.abs(np.asarray(got) - X.T @ r) / scale).max() < 1e-13


@pytest.mark.parametrize("n,k", [(5000, 30), (4097, 7), (2048, 512), (1000, 5)])
def test_matvec_matches_numpy(n, k):
    rng = np.random.default_rng(5 + n)
    X = rng.uniform(0.5, 1.0, (n, k)) * rng.choice([-1.0, 1.0], (n, k))
    v = rng.uniform(0.5, 1.0, k) * rng.choice([-1.0, 1.0], k)
    got = tm.DenseMatrix(X).matvec(jnp.asarray(v))
    scale = np.abs(X) @ np.abs(v)
    assert (np.abs(np.asarray(got) - X @ v) / scale).max() < 1e-13


def test_sandwich_dynamic_range_rows():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((5000, 4))
    X[::100] *= 1e8
    d = rng.random(5000)
    assert _relerr(tm.DenseMatrix(X).sandwich(d), (X * d[:, None]).T @ X) < 1e-13


def test_sandwich_zero_column():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((BT, 4))
    X[:, 2] = 0.0
    d = rng.uniform(0.5, 2.0, BT)
    out = np.asarray(tm.DenseMatrix(X).sandwich(d))
    assert np.all(out[2, :] == 0) and np.all(out[:, 2] == 0)
    keep = np.ix_([0, 1, 3], [0, 1, 3])
    assert _scaled_err(out[keep], ((X.T * d) @ X)[keep]) < 1e-13


@pytest.mark.parametrize("zero_every", [None, 3, 5])
def test_sandwich_signed_and_zero_weights(zero_every):
    # IRLS weights can be zero; signs must survive
    rng = np.random.default_rng(2)
    n, k = 4097, 21
    X = rng.standard_normal((n, k))
    d = rng.standard_normal(n)
    if zero_every:
        d[::zero_every] = 0.0
    ref = (X.T * d) @ X
    # signed d cancels in the true diagonal; scale by the |d| mass instead
    scale = (X.T * np.abs(d)) @ X
    assert _scaled_err(tm.DenseMatrix(X).sandwich(d), ref, scale) < 1e-13


def test_sandwich_long_mantissa_weights():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((BT, 5))
    d = np.nextafter(rng.uniform(0.5, 1.0, BT), np.inf)
    assert _scaled_err(tm.DenseMatrix(X).sandwich(d), (X.T * d) @ X) < 1e-13


def test_sandwich_extreme_scales():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((BT, 4))
    X[:, 0] *= 1e100
    X[:, 1] *= 1e-100
    d = rng.uniform(0.5, 2.0, BT) * 1e50
    assert _scaled_err(tm.DenseMatrix(X).sandwich(d), (X.T * d) @ X) < 1e-13


def test_tmv_zero_column_and_signs():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2500, 5))
    X[:, 2] = 0.0
    X[:, 3] = -np.abs(X[:, 3])
    r = rng.standard_normal(2500)
    r[::3] = 0.0
    got = np.asarray(tm.DenseMatrix(X).transpose_matvec(r))
    assert got[2] == 0.0
    np.testing.assert_allclose(got, X.T @ r, rtol=1e-13, atol=1e-13)


def test_tmv_long_mantissa():
    rng = np.random.default_rng(1)
    X = np.nextafter(rng.standard_normal((4000, 9)), np.inf)
    r = np.nextafter(rng.standard_normal(4000), -np.inf)
    got = np.asarray(tm.DenseMatrix(X).transpose_matvec(r))
    scale = np.abs(X.T) @ np.abs(r)
    assert (np.abs(got - X.T @ r) / scale).max() < 1e-13


def test_tmv_row_restricted():
    rng = np.random.default_rng(10)
    X = rng.standard_normal((3000, 13))
    r = rng.standard_normal(3000)
    rows = np.arange(0, 3000, 2)
    got = tm.DenseMatrix(X).transpose_matvec(r, rows=rows)
    np.testing.assert_allclose(np.asarray(got), X[rows].T @ r[rows], rtol=1e-12,
                               atol=1e-12)


def test_tmv_2d_operand_long_contraction():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((9000, 5))
    V = rng.standard_normal((9000, 3))
    out = np.asarray(dense_ops.transpose_matvec(jnp.asarray(X), jnp.asarray(V)))
    np.testing.assert_allclose(out, X.T @ V, rtol=1e-12)


@pytest.mark.parametrize("n,k", [(100, 3), (1024, 128), (2050, 50), (513, 200),
                                 (256, 2000)])
def test_sandwich_f32_at_f32_accuracy(n, k):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, k)).astype(np.float32)
    d = rng.random(n).astype(np.float32)
    ref = (X.astype(np.float64) * d[:, None]).T @ X.astype(np.float64)
    got = np.asarray(tm.DenseMatrix(X).sandwich(d))
    assert got.dtype == np.float32
    assert _relerr(got, ref) < np.sqrt(np.finfo(np.float32).eps)


@pytest.mark.parametrize("op", ["sandwich", "matvec", "transpose_matvec"])
def test_f32_probe_exact_in_f32(op):
    """Entries 1 + 2**-12 are exact in f32 and round to 1 in TF32."""
    x = 1.0 + 2.0**-12
    m = tm.DenseMatrix(np.full((256, 8), x, np.float32))
    want = {
        "sandwich": (lambda: m.sandwich(np.ones(256, np.float32)), 256 * x * x),
        "matvec": (lambda: m.matvec(np.ones(8, np.float32)), 8 * x),
        "transpose_matvec": (
            lambda: m.transpose_matvec(np.ones(256, np.float32)), 256 * x
        ),
    }[op]
    got = np.asarray(want[0](), dtype=np.float64)
    assert np.abs(got / want[1] - 1).max() < 2.0**-14
