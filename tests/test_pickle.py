"""Pickle round-trips: host containers persist, device mirrors rebuild lazily.

SURVEY §5: the reference's matrices are plain-pickleable (benchmark data is
pickled matrices); this library keeps host-side state pickleable and
re-uploads device arrays on first use after unpickling.
"""

import pickle

import numpy as np
import pytest
from scipy import sparse as sps

import tabmat_tpu as tm


def roundtrip(obj):
    return pickle.loads(pickle.dumps(obj))


def test_dense_pickle():
    rng = np.random.default_rng(0)
    m = tm.DenseMatrix(rng.standard_normal((20, 3)), column_names=["a", "b", "c"])
    m2 = roundtrip(m)
    np.testing.assert_allclose(m2.toarray(), m.toarray())
    assert m2.column_names == ["a", "b", "c"]
    d = rng.random(20)
    np.testing.assert_allclose(
        np.asarray(m2.sandwich(d)), np.asarray(m.sandwich(d)), atol=1e-14
    )


def test_sparse_pickle():
    m = tm.SparseMatrix(sps.random(30, 4, density=0.3, random_state=0))
    m2 = roundtrip(m)
    np.testing.assert_allclose(m2.toarray(), m.toarray())
    d = np.random.default_rng(1).random(30)
    np.testing.assert_allclose(m2.sandwich(d), m.sandwich(d), atol=1e-14)


def test_categorical_pickle():
    m = tm.CategoricalMatrix(["a", "b", "a", "c"], column_name="cat")
    m._ = m.plan  # force device state before pickling
    m2 = roundtrip(m)
    np.testing.assert_allclose(m2.toarray(), m.toarray())
    assert m2.column_names == m.column_names
    d = np.random.default_rng(2).random(4)
    np.testing.assert_allclose(
        np.asarray(m2.sandwich(d).diag), np.asarray(m.sandwich(d).diag), atol=1e-14
    )


def test_split_and_standardized_pickle():
    rng = np.random.default_rng(3)
    split = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((25, 2))),
            tm.CategoricalMatrix(rng.integers(0, 3, 25), categories=np.arange(3)),
        ]
    )
    w = np.full(25, 1 / 25)
    std, _, _ = split.standardize(w, True, True)
    std2 = roundtrip(std)
    np.testing.assert_allclose(std2.toarray(), std.toarray())
    d = rng.random(25)
    np.testing.assert_allclose(std2.sandwich(d), std.sandwich(d), atol=1e-12)
