"""Categorical and sparse reductions against numpy/scipy oracles.

The shapes are the cases that once guarded the one-hot segment-sum,
windowed-take, fused sparse transpose-matvec and wide-sparse kernels;
they now hold the plain routes that replaced them (``SegmentPlan``
cumsum differences, ``jnp.take`` gathers and the CSR/CSC walks) to the
same references.
"""

import numpy as np
import pytest
import scipy.sparse as sps

import jax.numpy as jnp

import tabmat_tpu as tm
from tabmat_tpu.ops import sparse_ops
from tabmat_tpu.ops.segments import build_plan


def _codes_with_missing(rng, n, W):
    codes = rng.integers(0, W, n).astype(np.int32)
    codes[rng.choice(n, max(n // 50, 1), replace=False)] = -1
    return codes


@pytest.mark.parametrize(
    "n,W", [(5000, 3000), (20000, 100000), (4096, 1500), (2048, 1025), (100, 2000)]
)
@pytest.mark.parametrize("op", ["transpose_matvec", "sandwich"])
def test_categorical_segment_sums_match_bincount(n, W, op):
    rng = np.random.default_rng(n + W)
    codes = _codes_with_missing(rng, n, W)
    cm = tm.CategoricalMatrix(codes, categories=np.arange(W), cat_missing_method="zero")
    v = rng.standard_normal(n) * np.exp(rng.uniform(-6, 6, n))
    valid = codes >= 0
    ref = np.bincount(codes[valid], weights=v[valid], minlength=W)
    if op == "sandwich":
        got = cm.sandwich(jnp.asarray(v)).diag
    else:
        got = cm.transpose_matvec(jnp.asarray(v))
    # cumsum differences round at the magnitude of the running total
    assert np.abs(np.asarray(got) - ref).max() / np.abs(v).sum() < 1e-13


def test_categorical_segment_sum_f32():
    rng = np.random.default_rng(1)
    n, W = 30000, 50000
    codes = rng.integers(0, W, n).astype(np.int32)
    cm = tm.CategoricalMatrix(codes, categories=np.arange(W), dtype=np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(cm.transpose_matvec(jnp.asarray(v)))
    assert got.dtype == np.float32
    ref = np.bincount(codes, weights=v.astype(np.float64), minlength=W)
    assert np.abs(got - ref).max() / np.abs(v).sum() < 1e-6


def test_categorical_empty_segments_and_missing_block():
    rng = np.random.default_rng(2)
    n, W = 6000, 4096
    codes = rng.integers(0, W // 2, n).astype(np.int32)
    codes[1000:2024] = -1  # a whole block of missing rows
    cm = tm.CategoricalMatrix(codes, categories=np.arange(W), cat_missing_method="zero")
    v = rng.standard_normal(n)
    got = np.asarray(cm.transpose_matvec(v))
    assert np.all(got[W // 2:] == 0.0)
    valid = codes >= 0
    np.testing.assert_allclose(
        got, np.bincount(codes[valid], weights=v[valid], minlength=W), atol=1e-12
    )


@pytest.mark.parametrize("drop_first", [False, True])
def test_categorical_matvec_gather_is_exact(drop_first):
    rng = np.random.default_rng(3)
    n, W = 100_000, 5000
    codes = rng.integers(-1 if not drop_first else 0, W, n).astype(np.int32)
    cm = tm.CategoricalMatrix(codes, categories=np.arange(W), drop_first=drop_first,
                              cat_missing_method="zero")
    v = rng.standard_normal(cm.shape[1])
    eff = codes - int(drop_first)
    ref = np.where(eff >= 0, v[np.clip(eff, 0, None)], 0.0)
    np.testing.assert_array_equal(np.asarray(cm.matvec(jnp.asarray(v))), ref)


def test_segment_plan_sum_signed_wide_range():
    rng = np.random.default_rng(1)
    n, W = 300_000, 2000
    codes = rng.integers(-1, W, n).astype(np.int32)
    v = rng.standard_normal(n) * np.exp(rng.uniform(-6, 6, n))
    got = np.asarray(build_plan(codes, W).sum(jnp.asarray(v)))
    valid = codes >= 0
    ref = np.bincount(codes[valid], weights=v[valid], minlength=W)
    assert np.abs(got - ref).max() / np.abs(v).sum() < 1e-13


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,src_len", [(1000, 500), (40_000, 40_000), (70_000, 3_000)])
def test_bounded_segment_sum_monotone_bounds(dtype, n, src_len):
    """Segment sums at sorted bounds: the boundary takes of every CSR walk."""
    rng = np.random.default_rng(n + src_len)
    bounds = np.sort(rng.integers(0, src_len + 1, n)).astype(np.int64)
    bounds[0], bounds[-1] = 0, src_len
    vals = (rng.standard_normal(src_len) * np.exp(rng.uniform(-4, 4, src_len))).astype(
        dtype
    )
    got = np.asarray(sparse_ops.bounded_segment_sum(jnp.asarray(vals), jnp.asarray(bounds)))
    assert got.dtype == dtype
    ref = np.add.reduceat(np.append(vals.astype(np.float64), 0.0), bounds[:-1])
    ref[bounds[:-1] == bounds[1:]] = 0.0
    eps = np.finfo(dtype).eps
    assert np.abs(got - ref).max() / np.abs(vals.astype(np.float64)).sum() < 64 * eps


def test_bounded_segment_sum_indptr_with_flat_stretches():
    rng = np.random.default_rng(7)
    nnz = 5000
    bounds = np.concatenate([[0], np.sort(rng.integers(0, nnz, 3_000)), [nnz]])
    vals = rng.standard_normal(nnz)
    got = np.asarray(sparse_ops.bounded_segment_sum(jnp.asarray(vals), jnp.asarray(bounds)))
    ref = np.array([vals[a:b].sum() for a, b in zip(bounds[:-1], bounds[1:])])
    np.testing.assert_allclose(got, ref, atol=1e-12)


def _scaled_tmv_err(got, X, v):
    scale = np.abs(X.T) @ np.abs(v) + 1e-300
    return np.max(np.abs(np.asarray(got, dtype=np.float64) - X.T @ v) / scale)


@pytest.mark.parametrize(
    "n,k,density",
    [(20_000, 100, 0.01), (30_000, 3, 0.01), (999, 130, 0.05), (5_000, 512, 0.01),
     (400, 1, 0.5)],
)
@pytest.mark.parametrize("caller", ["jax", "numpy"])
def test_sparse_transpose_matvec_matches_scipy(n, k, density, caller):
    rng = np.random.default_rng(42)
    X = sps.random(n, k, density=density, random_state=rng, format="csc")
    X.data = rng.standard_normal(X.nnz)
    v = rng.standard_normal(n)
    m = tm.SparseMatrix(X)
    got = m.transpose_matvec(jnp.asarray(v) if caller == "jax" else v)
    assert _scaled_tmv_err(got, X, v) < 5e-14


def test_sparse_tmv_empty_columns():
    rng = np.random.default_rng(3)
    X = sps.random(5_000, 50, density=0.01, random_state=rng, format="csc")
    X = sps.hstack([X[:, :20], sps.csc_matrix((5_000, 5)), X[:, 20:]]).tocsc()
    v = rng.standard_normal(5_000)
    got = np.asarray(tm.SparseMatrix(X).transpose_matvec(jnp.asarray(v)))
    assert np.all(got[20:25] == 0.0)
    assert _scaled_tmv_err(got, X, v) < 5e-14


def test_sparse_tmv_f32():
    rng = np.random.default_rng(7)
    X = sps.random(8_000, 60, density=0.02, random_state=rng, format="csc",
                   dtype=np.float32)
    X.data = rng.standard_normal(X.nnz).astype(np.float32)
    v = rng.standard_normal(8_000).astype(np.float32)
    got = tm.SparseMatrix(X).transpose_matvec(jnp.asarray(v))
    Xd = X.astype(np.float64)
    assert _scaled_tmv_err(got, Xd, v.astype(np.float64)) < 1e-6


def test_sparse_tmv_wide_dynamic_range():
    rng = np.random.default_rng(11)
    X = sps.random(20_000, 100, density=0.01, random_state=rng, format="csc")
    X.data = rng.standard_normal(X.nnz) * np.exp(rng.standard_normal(X.nnz) * 4)
    v = rng.standard_normal(20_000)
    got = tm.SparseMatrix(X).transpose_matvec(jnp.asarray(v))
    assert _scaled_tmv_err(got, X, v) < 1e-12


def _wide(n, k, density, seed=0):
    A = sps.random(n, k, density=density, format="csc", random_state=seed)
    A.data = A.data * np.exp(np.random.default_rng(seed).uniform(-6, 6, A.nnz))
    return A


# The CSR/CSC walks and the pair sandwich are cumsum differences over the
# nonzeros: they round at the magnitude of the running total, so their
# error is bounded by a few eps times the op's total mass sum|terms|.
MASS_TOL = 64 * np.finfo(np.float64).eps


@pytest.mark.parametrize("n,k", [(500, 700), (1000, 300)])
@pytest.mark.parametrize("op", ["matvec", "transpose_matvec"])
def test_wide_sparse_matvecs(n, k, op):
    A = _wide(n, k, 0.02, seed=n)
    rng = np.random.default_rng(1)
    m = tm.SparseMatrix(A)
    if op == "matvec":
        v = rng.standard_normal(k) * np.exp(rng.uniform(-4, 4, k))
        got, ref, mass = m.matvec(jnp.asarray(v)), A @ v, abs(A) @ np.abs(v)
    else:
        v = rng.standard_normal(n) * np.exp(rng.uniform(-4, 4, n))
        got, ref, mass = m.transpose_matvec(jnp.asarray(v)), A.T @ v, abs(A.T) @ np.abs(v)
    assert np.abs(np.asarray(got) - ref).max() / mass.sum() < MASS_TOL


def test_wide_sparse_matvec_zero_vector():
    A = _wide(300, 400, 0.03, seed=5)
    out = np.asarray(tm.SparseMatrix(A).matvec(jnp.zeros(400)))
    assert np.all(out == 0)


@pytest.mark.parametrize("n,k", [(3000, 600), (500, 5000)])
def test_wide_sparse_sandwich_matches_scipy(n, k):
    rng = np.random.default_rng(2)
    A = sps.random(n, k, density=0.02, random_state=3, format="csc")
    d = rng.random(n)
    S = np.asarray(tm.SparseMatrix(A).sandwich(d))
    Sref = (A.T @ sps.diags(d) @ A).toarray()
    mass = float(d @ np.asarray(abs(A).sum(axis=1)).ravel() ** 2)
    assert np.abs(S - Sref).max() / mass < MASS_TOL


def test_sparse_matvec_and_tmv_benchmark_shape():
    rng = np.random.default_rng(12)
    S = sps.random(40_000, 100, density=0.01, format="csc", random_state=5)
    X = tm.SparseMatrix(S)
    v = rng.standard_normal(100)
    w = rng.standard_normal(40_000)
    got_mv = np.asarray(X.matvec(jnp.asarray(v)))
    got_tmv = np.asarray(X.transpose_matvec(jnp.asarray(w)))
    assert np.abs(got_mv - S @ v).max() / (abs(S) @ np.abs(v)).sum() < MASS_TOL
    assert np.abs(got_tmv - S.T @ w).max() / (abs(S.T) @ np.abs(w)).sum() < MASS_TOL
