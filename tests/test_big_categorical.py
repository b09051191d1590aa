"""Big-categorical / read-only-buffer regression battery.

Analog of the reference's ``tests/test_big_categorical_matrix.py:10-114``:
at ~800k rows × ~58k categories pandas hands out *read-only* code buffers,
and every kernel (transpose_matvec, cross-sandwiches, multiply, tocsr) must
accept them; cross-products between huge categoricals must route through
the compressed (observed-pairs) plan instead of densifying K1×K2 bounds.

Also pins the index-dtype contract of the sparse pair-expansion sandwich
(reference ``tests/test_fast_sandwich.py:33-48``): combined pair keys are
built in int64 — at >2^31 pair cells int32 indexing would wrap (the
reference documents the same requirement for its C++ kernels).
"""

import numpy as np
import pandas as pd
import pytest

import tabmat_tpu as tm

N_BIG = 797_586
N_CATEGORIES = 58_059


def make_categorical_matrix(n, n_categories, **categorical_kwargs):
    categories = [f"cat[{i}]" for i in range(n_categories)]
    indices = np.linspace(0, n_categories - 1, n).round().astype(int)
    cat_vec = pd.Series(pd.Categorical.from_codes(indices, categories=categories))
    return tm.CategoricalMatrix(cat_vec, **categorical_kwargs)


@pytest.fixture(scope="module")
def big_categorical_matrix():
    mat = make_categorical_matrix(N_BIG, N_CATEGORIES)
    # pandas yields read-only codes at this scale; pin it so the fixture
    # keeps guarding the read-only contract even if pandas changes
    mat.indices.flags.writeable = False
    return mat


@pytest.fixture(scope="module")
def big_categorical_matrix_drop_first():
    mat = make_categorical_matrix(N_BIG, N_CATEGORIES, drop_first=True)
    mat.indices.flags.writeable = False
    return mat


def test_transpose_matvec_big_readonly(big_categorical_matrix):
    weights = np.ones(N_BIG)
    result = big_categorical_matrix.transpose_matvec(weights)
    # every category collects exactly its multiplicity
    expected = np.bincount(big_categorical_matrix.indices, minlength=N_CATEGORIES)
    np.testing.assert_allclose(np.asarray(result), expected)


def test_sandwich_diag_big_readonly(big_categorical_matrix):
    d = np.full(N_BIG, 0.5)
    res = big_categorical_matrix.sandwich(d)
    expected = 0.5 * np.bincount(
        big_categorical_matrix.indices, minlength=N_CATEGORIES
    )
    np.testing.assert_allclose(np.asarray(res.diag), expected)


@pytest.mark.parametrize("n_cat_A,n_cat_B", [(N_CATEGORIES, 2725), (2725, N_CATEGORIES)])
def test_sandwich_cat_cat_big(n_cat_A, n_cat_B):
    # K1·K2 ≈ 1.6e8 cells: far beyond the dense-plan budget, must take the
    # compressed observed-pairs route and still give exact counts
    weights = np.ones(N_BIG) / N_BIG
    A = make_categorical_matrix(N_BIG, n_cat_A)
    B = make_categorical_matrix(N_BIG, n_cat_B)
    A.indices.flags.writeable = False
    B.indices.flags.writeable = False
    res = A._cross_categorical(
        B, weights, np.arange(N_BIG), np.arange(n_cat_A), np.arange(n_cat_B)
    )
    assert res.shape == (n_cat_A, n_cat_B)
    # total mass is preserved and each (row-code, col-code) pair lands once
    assert np.isclose(res.sum(), 1.0)


def test_cross_dense_big_readonly(big_categorical_matrix):
    n_dense_cols = 10
    dense = tm.DenseMatrix(np.ones((N_BIG, n_dense_cols)))
    weights = np.ones(N_BIG) / N_BIG
    res = big_categorical_matrix._cross_sandwich(
        dense,
        weights,
        np.arange(N_BIG),
        np.arange(N_CATEGORIES),
        np.arange(n_dense_cols),
    )
    assert res.shape == (N_CATEGORIES, n_dense_cols)
    expected_col = (
        np.bincount(big_categorical_matrix.indices, minlength=N_CATEGORIES) / N_BIG
    )
    # cumsum-plan prefix rounding is absolute in the total mass (~n·eps·Σ|w|)
    np.testing.assert_allclose(np.asarray(res)[:, 0], expected_col, atol=1e-13)


def test_multiply_big_readonly_drop_first(big_categorical_matrix_drop_first):
    res = big_categorical_matrix_drop_first.multiply(np.ones(N_BIG))
    assert res is not None


def test_tocsr_big_readonly_drop_first(big_categorical_matrix_drop_first):
    csr = big_categorical_matrix_drop_first.tocsr()
    assert csr.shape == big_categorical_matrix_drop_first.shape
    # drop_first: rows whose code was 0 are empty
    assert csr.nnz == int((big_categorical_matrix_drop_first.indices != 0).sum())


def test_matvec_big_readonly(big_categorical_matrix):
    v = np.arange(N_CATEGORIES, dtype=np.float64)
    res = np.asarray(big_categorical_matrix.matvec(v))
    np.testing.assert_allclose(
        res, v[big_categorical_matrix.indices], rtol=0, atol=0
    )


def test_pair_expansion_int64_key_path():
    """Pair-cell keys are formed in int64 once k² exceeds 2^24.

    Mirrors the reference's >2^31 sparse-sandwich indexing requirement
    (``tests/test_fast_sandwich.py:33-48``): the reference's kernels segfault
    with int32 indices past 2^31 cells; here the equivalent hazard is the
    combined key ``col_a * k + col_b``, which the int64 path must survive.
    k=5000 (k² = 2.5e7 > 2^24) routes through that path at CI-feasible size.
    """
    from scipy import sparse as sps

    rng = np.random.default_rng(0)
    k, n = 5000, 400
    A = sps.random(n, k, density=0.002, random_state=1, format="csr")
    sm = tm.SparseMatrix(A.tocsc())
    parts = sm._pair_sandwich_parts()
    assert parts is not None  # within the documented pair budget
    d = rng.random(n)
    got = np.asarray(sm.sandwich(d))
    want = (A.T @ sps.diags(d) @ A).toarray()
    np.testing.assert_allclose(got, want, atol=1e-12)
