"""The formulaic upstream test battery, adapted to the native engine.

The reference ends its formula suite with a vendored copy of formulaic's
own test-suite (``tests/test_formula.py:999-1294``,
``class TestFormulaicTests``).  tabmat-tpu's formula engine is own-written
(formulaic is unavailable here), so this file adapts every one of those
tests to the native surface: ``tm.from_formula`` plays the materializer,
``matrix.model_spec`` plays formulaic's ModelSpec, and the handful of
tests that poke formulaic *internals* (Factor kinds, encoder caches) are
re-expressed as assertions on the equivalent engine behaviors.

Expectations are byte-identical to the upstream values; inputs are
parametrized over pandas and pyarrow (plus polars, activating if ever
installed), matching the reference's pandas/polars pairing with the
backends available in this environment.
"""

import pickle

import numpy as np
import pandas as pd
import pytest

import tabmat_tpu as tm

try:
    import polars as pl

    HAS_POLARS = True
except ImportError:
    HAS_POLARS = False

try:
    import pyarrow as pa

    HAS_PYARROW = True
except ImportError:
    HAS_PYARROW = False

INPUTS = [
    "pandas",
    pytest.param(
        "polars",
        marks=pytest.mark.skipif(not HAS_POLARS, reason="polars not installed"),
    ),
    pytest.param(
        "pyarrow",
        marks=pytest.mark.skipif(not HAS_PYARROW, reason="pyarrow not installed"),
    ),
]


def _convert(df, input):
    if input == "polars":
        return pl.from_pandas(df)
    if input == "pyarrow":
        return pa.Table.from_pandas(df)
    return df


# reference test_formula.py:948-996 — formula: (full_rank_names, names,
# full_rank_null_names, null_rows)
FORMULAIC_TESTS = {
    "a": (["Intercept", "a"], ["Intercept", "a"], ["Intercept", "a"], 2),
    "A": (
        ["Intercept", "A[b]", "A[c]"],
        ["Intercept", "A[a]", "A[b]", "A[c]"],
        ["Intercept", "A[c]"],
        2,
    ),
    "C(A)": (
        ["Intercept", "C(A)[b]", "C(A)[c]"],
        ["Intercept", "C(A)[a]", "C(A)[b]", "C(A)[c]"],
        ["Intercept", "C(A)[c]"],
        2,
    ),
    "A:a": (
        ["Intercept", "A[a]:a", "A[b]:a", "A[c]:a"],
        ["Intercept", "A[a]:a", "A[b]:a", "A[c]:a"],
        ["Intercept", "A[a]:a"],
        1,
    ),
    "A:B": (
        [
            "Intercept",
            "B[b]",
            "B[c]",
            "A[b]:B[a]",
            "A[c]:B[a]",
            "A[b]:B[b]",
            "A[c]:B[b]",
            "A[b]:B[c]",
            "A[c]:B[c]",
        ],
        [
            "Intercept",
            "A[a]:B[a]",
            "A[b]:B[a]",
            "A[c]:B[a]",
            "A[a]:B[b]",
            "A[b]:B[b]",
            "A[c]:B[b]",
            "A[a]:B[c]",
            "A[b]:B[c]",
            "A[c]:B[c]",
        ],
        ["Intercept"],
        1,
    ),
}


@pytest.fixture
def data(input):
    df = pd.DataFrame(
        {"a": [1, 2, 3], "b": [1, 2, 3], "A": ["a", "b", "c"], "B": ["a", "b", "c"]}
    )
    return _convert(df, input)


@pytest.fixture
def data_with_nulls(input):
    df = pd.DataFrame(
        {"a": [1.0, 2, None], "A": ["a", None, "c"], "B": ["a", "b", None]}
    )
    return _convert(df, input)


class TestFormulaicTests:
    """Adapted twin of the reference's vendored formulaic suite."""

    @pytest.mark.parametrize("input", INPUTS)
    @pytest.mark.parametrize("formula,tests", FORMULAIC_TESTS.items())
    def test_get_model_matrix(self, data, formula, tests):
        mm = tm.from_formula(
            formula, data, ensure_full_rank=True, include_intercept=True
        )
        assert isinstance(mm, tm.MatrixBase)
        assert mm.shape == (3, len(tests[0]))
        assert list(mm.model_spec.column_names) == tests[0]

        mm = tm.from_formula(
            formula, data, ensure_full_rank=False, include_intercept=True
        )
        assert isinstance(mm, tm.MatrixBase)
        assert mm.shape == (3, len(tests[1]))
        assert list(mm.model_spec.column_names) == tests[1]

    @pytest.mark.parametrize("input", INPUTS)
    def test_get_model_matrix_edge_cases(self, data):
        # upstream: structured (lhs ~ rhs) formulas materialize both sides;
        # here the rhs comes from from_formula and the lhs from the
        # engine's response materializer
        from tabmat_tpu.formula.engine import materialize_response

        mm = tm.from_formula(
            "a ~ A", data, ensure_full_rank=True, include_intercept=True
        )
        assert isinstance(mm, tm.MatrixBase)
        assert list(mm.model_spec.column_names) == ["Intercept", "A[b]", "A[c]"]
        y = materialize_response("a ~ A", data)
        np.testing.assert_array_equal(np.asarray(y, dtype=float), [1.0, 2.0, 3.0])

    @pytest.mark.parametrize("input", INPUTS)
    def test_get_model_matrix_invalid_output(self, data):
        # upstream: an invalid materializer output name raises with a
        # message listing the valid choices; the engine's equivalent
        # enumerated knobs are na_action and cluster_by
        with pytest.raises(ValueError, match=r"na_action must be one of"):
            tm.from_formula("a", data, na_action="invalid_output")
        with pytest.raises(ValueError, match=r"cluster_by must be"):
            tm.from_formula("a", data, cluster_by="invalid_output")

    @pytest.mark.parametrize("input", INPUTS)
    @pytest.mark.parametrize("formula,tests", FORMULAIC_TESTS.items())
    def test_na_handling(self, data_with_nulls, formula, tests):
        mm = tm.from_formula(
            formula,
            data_with_nulls,
            cat_missing_method="zero",
            na_action="drop",
            ensure_full_rank=True,
            include_intercept=True,
        )
        assert isinstance(mm, tm.MatrixBase)
        assert mm.shape == (tests[3], len(tests[2]))
        assert list(mm.model_spec.column_names) == tests[2]

        if formula == "A:B":
            return

        mm = tm.from_formula(
            formula,
            data_with_nulls,
            cat_missing_method="zero",
            na_action="ignore",
            ensure_full_rank=True,
            include_intercept=True,
        )
        assert isinstance(mm, tm.MatrixBase)
        assert mm.shape == (3, len(tests[0]) + (-1 if "A" in formula else 0))

    @pytest.mark.parametrize("input", INPUTS)
    def test_state(self, data):
        mm = tm.from_formula("center(a) - 1", data)
        assert isinstance(mm, tm.MatrixBase)
        assert list(mm.model_spec.column_names) == ["center(a)"]
        np.testing.assert_allclose(
            np.asarray(mm.getcol(0).unpack()).squeeze(), [-1, 0, 1]
        )

        mm2 = mm.model_spec.get_model_matrix(pd.DataFrame({"a": [4, 5, 6]}))
        assert isinstance(mm2, tm.MatrixBase)
        assert list(mm2.model_spec.column_names) == ["center(a)"]
        np.testing.assert_allclose(
            np.asarray(mm2.getcol(0).unpack()).squeeze(), [2, 3, 4]
        )

        # a pickled spec re-materializes identically (upstream round-trips
        # the spec through a second materializer instance)
        spec = pickle.loads(pickle.dumps(mm.model_spec))
        mm3 = spec.get_model_matrix(pd.DataFrame({"a": [4, 5, 6]}))
        np.testing.assert_allclose(
            np.asarray(mm3.getcol(0).unpack()).squeeze(), [2, 3, 4]
        )

    @pytest.mark.parametrize("input", INPUTS)
    def test_factor_evaluation_edge_cases(self, data):
        # upstream: a numerical column is coerced categorical when the
        # spec says so (Factor kind="categorical")
        mm = tm.from_formula("C(a) - 1", data, ensure_full_rank=False)
        assert list(mm.model_spec.column_names) == ["C(a)[1]", "C(a)[2]", "C(a)[3]"]
        np.testing.assert_array_equal(mm.toarray(), np.eye(3))

        # upstream: kind mismatches against the remembered encoder state
        # raise; the engine's equivalent is re-materializing a remembered
        # categorical factor against out-of-state (unseen) values
        spec = tm.from_formula("A - 1", data, ensure_full_rank=False).model_spec
        with pytest.raises(ValueError, match="unseen categories"):
            spec.get_model_matrix(pd.DataFrame({"A": [1, 2, 3]}))

    @pytest.mark.parametrize("input", INPUTS)
    def test_encoding_edge_cases(self, data):
        # constant (literal) factors encode as constant columns
        mm = tm.from_formula("10 - 1", data)
        np.testing.assert_array_equal(
            np.asarray(mm.toarray()).squeeze(), [10, 10, 10]
        )

        # multi-column numerical factors (the upstream dict-valued factor)
        # expand with bracketed names; poly() is the engine's native
        # multi-output factor
        mm = tm.from_formula("poly(a, 2) - 1", data)
        assert mm.shape == (3, 2)
        assert all("poly" in nm for nm in mm.column_names)

        # categorical encoding through C() honors cat_threshold routing
        mm = tm.from_formula("C(A) - 1", data, cat_threshold=1)
        assert mm.shape == (3, 3)

    @pytest.mark.parametrize("input", INPUTS)
    def test_empty(self, data):
        mm = tm.from_formula("0", data, ensure_full_rank=True)
        assert mm.shape[1] == 0
        mm = tm.from_formula("0", data, ensure_full_rank=False)
        assert mm.shape[1] == 0

    @pytest.mark.parametrize("input", INPUTS)
    def test_category_reordering(self, input):
        data = _convert(pd.DataFrame({"A": ["a", "b", "c"]}), input)
        data2 = _convert(pd.DataFrame({"A": ["c", "b", "a"]}), input)
        data3 = _convert(
            pd.DataFrame(
                {"A": pd.Categorical(["c", "b", "a"], categories=["c", "b", "a"])}
            ),
            input,
        )

        m = tm.from_formula("A + 0", data, ensure_full_rank=False)
        assert list(m.model_spec.column_names) == ["A[a]", "A[b]", "A[c]"]

        m2 = tm.from_formula("A + 0", data2, ensure_full_rank=False)
        assert list(m2.model_spec.column_names) == ["A[a]", "A[b]", "A[c]"]

        m3 = tm.from_formula("A + 0", data3, ensure_full_rank=False)
        if input == "pandas":
            # explicit pandas Categorical order is honored
            assert list(m3.model_spec.column_names) == ["A[c]", "A[b]", "A[a]"]
        else:
            # non-pandas backends factorize sorted, matching the reference's
            # generic narwhals extraction (categorical_matrix.py:275-293) —
            # its formula path routes through the same function
            assert list(m3.model_spec.column_names) == ["A[a]", "A[b]", "A[c]"]

    @pytest.mark.parametrize("input", INPUTS)
    def test_term_clustering(self, data):
        mm = tm.from_formula(
            "a + b + a:A + b:A",
            data,
            ensure_full_rank=True,
            include_intercept=True,
        )
        assert tuple(mm.model_spec.column_names) == (
            "Intercept",
            "a",
            "b",
            "a:A[b]",
            "a:A[c]",
            "b:A[b]",
            "b:A[c]",
        )
        mm = tm.from_formula(
            "a + b + a:A + b:A",
            data,
            ensure_full_rank=True,
            include_intercept=True,
            cluster_by="numerical_factors",
        )
        assert tuple(mm.model_spec.column_names) == (
            "Intercept",
            "a",
            "a:A[b]",
            "a:A[c]",
            "b",
            "b:A[b]",
            "b:A[c]",
        )

    @pytest.mark.parametrize("input", INPUTS)
    def test_model_spec_pickleable(self, data):
        ms = tm.from_formula("a ~ a:A", data).model_spec
        ms2 = pickle.loads(pickle.dumps(ms))
        assert ms2.formula == "a ~ a:A"
        # the unpickled spec still re-materializes with remembered levels
        mm = ms2.get_model_matrix(
            pd.DataFrame({"a": [1, 2, 3], "A": ["a", "b", "c"]})
        )
        assert mm.shape[0] == 3
