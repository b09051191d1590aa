"""CategoricalMatrix: a one-hot matrix stored as a single int32 code vector.

Parity target: reference ``tabmat/categorical_matrix.py:319-980``.  The math
(derived in the reference module docstring, ``categorical_matrix.py:1-163``):

- ``matvec(v)[i] = v[codes[i]]``            — one gather
- ``transpose_matvec(v)[c] = Σ_{codes[i]=c} v[i]``  — segment-sum
- ``sandwich(d)`` is **diagonal**: ``diag(Σ_{codes[i]=c} d[i])``

``drop_first`` and missing values ('fail'|'zero'|'convert') reduce to a code
shift: ``eff = codes - drop_first`` with negative codes contributing nothing
— a single unified path instead of the reference's fast/complex kernel split
(``categorical_matrix.py:526-537``).

Device design: the code vector lives in device memory; reductions use the
cached argsort/cumsum SegmentPlan (no atomics/scatter); cross-products
against dense blocks become segment-summed row reductions (see
``SplitMatrix``).
"""

import warnings
import weakref
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import categorical_ops
from ..ops.diag import DiagonalResult
from ..ops.segments import SegmentPlan, build_plan
from ..utils import (
    _check_indexer,
    add_into_out,
    check_matvec_dimensions,
    check_matvec_out_shape,
    check_sandwich_compatible,
    check_transpose_matvec_out_shape,
    is_jax_array,
    result_like,
    rows_to_mask,
    set_up_rows_or_cols,
)
from .base import MatrixBase

try:
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None

try:
    import narwhals.stable.v2 as nw
except ImportError:  # pragma: no cover
    nw = None


def _factorize_numpy(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Minimal factorize for when pandas is unavailable."""
    na_mask = (x == None) | (x != x)  # noqa: E711  (second term catches NaN)
    categories, inverse = np.unique(x[~na_mask], return_inverse=True)
    codes = np.full(x.shape, -1, dtype=np.int64)
    codes[~na_mask] = inverse
    return codes, categories


def _extract_codes_and_categories(cat_vec) -> tuple[np.ndarray, np.ndarray]:
    """Extract (codes, categories) from any supported series/vector.

    Missing values map to code -1.  Pandas categoricals keep their declared
    category order; everything else is factorized in sorted order (matching
    reference ``categorical_matrix.py:221-293``).
    """
    native = cat_vec
    if nw is not None:
        native = nw.to_native(cat_vec, pass_through=True)

    if pd is not None and isinstance(native, (pd.Series, pd.Categorical)):
        if isinstance(native, pd.Categorical):
            return np.asarray(native.codes), np.asarray(native.categories)
        if isinstance(native.dtype, pd.CategoricalDtype):
            return (
                native.cat.codes.to_numpy(),
                np.asarray(native.cat.categories),
            )
        codes, categories = pd.factorize(native, sort=True)
        return codes, np.asarray(categories)

    if nw is not None:
        maybe_series = nw.from_native(cat_vec, series_only=True, pass_through=True)
        if isinstance(maybe_series, nw.Series):
            arr = maybe_series.cast(nw.String).to_numpy()
        else:
            arr = np.asarray(native)
    else:
        arr = np.asarray(native)

    if pd is not None:
        codes, categories = pd.factorize(arr, sort=True)
        return codes, np.asarray(categories)
    return _factorize_numpy(arr)


def _is_indexer_full_length(full_length: int, indexer) -> bool:
    if isinstance(indexer, np.ndarray):
        if (indexer > full_length - 1).any():
            raise IndexError("Index out-of-range.")
        return np.array_equal(indexer.ravel(), np.arange(full_length))
    if isinstance(indexer, slice):
        return len(range(*indexer.indices(full_length))) == full_length
    return False


class CategoricalMatrix(MatrixBase):
    """One-hot encoded categorical column stored as an int32 code vector.

    Parameters mirror the reference: ``cat_vec`` (data or codes when
    ``categories`` is given), ``drop_first``, ``cat_missing_method``
    ('fail'|'zero'|'convert'), ``cat_missing_name``, dtype, and naming.

    Examples
    --------
    >>> import numpy as np, tabmat_tpu as tm
    >>> C = tm.CategoricalMatrix(np.array([0, 1, 2, 1]), categories=np.arange(3))
    >>> C.shape
    (4, 3)
    >>> C.toarray()
    array([[1., 0., 0.],
           [0., 1., 0.],
           [0., 0., 1.],
           [0., 1., 0.]])
    >>> np.asarray(C.transpose_matvec(np.array([1.0, 2.0, 3.0, 4.0])))
    array([1., 6., 3.])
    """

    def __init__(
        self,
        cat_vec,
        categories: Optional[np.ndarray] = None,
        drop_first: bool = False,
        dtype=np.float64,
        column_name: Optional[str] = None,
        term_name: Optional[str] = None,
        column_name_format: str = "{name}[{category}]",
        cat_missing_method: str = "fail",
        cat_missing_name: str = "(MISSING)",
    ):
        if cat_missing_method not in {"fail", "zero", "convert"}:
            raise ValueError(
                "cat_missing_method must be one of 'fail' 'zero' or 'convert'; "
                f" got {cat_missing_method}."
            )

        if not hasattr(cat_vec, "dtype"):
            cat_vec = np.asarray(cat_vec)

        self._missing_method = cat_missing_method
        self._missing_category = cat_missing_name

        if categories is not None:
            self.categories = np.asarray(categories)
            codes = np.nan_to_num(np.asarray(cat_vec), nan=-1)
            if codes.size:
                if np.max(codes) >= len(self.categories):
                    raise ValueError("Indices exceed length of categories.")
                if np.min(codes) < -1:
                    raise ValueError(
                        "Indices must be non-negative (or -1 for missing)."
                    )
        else:
            codes, self.categories = _extract_codes_and_categories(cat_vec)

        codes = np.asarray(codes)
        if np.any(codes == -1):
            if self._missing_method == "fail":
                raise ValueError(
                    "Categorical data can't have missing values "
                    "if cat_missing_method='fail'."
                )
            elif self._missing_method == "convert":
                if self._missing_category in self.categories:
                    raise ValueError(
                        f"Missing category {self._missing_category} already exists."
                    )
                self.categories = np.hstack(
                    [self.categories, self._missing_category], dtype="object"
                )
                codes = np.where(codes < 0, len(self.categories) - 1, codes)
                self._has_missings = False
            else:
                self._has_missings = True
        else:
            self._has_missings = False

        self.drop_first = drop_first
        try:
            self.indices = codes.astype(np.int32, copy=False)
        except (ValueError, TypeError):
            raise ValueError(
                "When creating a CategoricalMatrix with indices and categories, "
                "indices must be castable to a numpy int32 dtype."
            )
        self.shape = (
            len(self.indices),
            max(len(self.categories) - int(drop_first), 0),
        )
        self.dtype = np.dtype(dtype)

        self._colname = column_name
        self._colname_format = column_name_format
        self._term = column_name if term_name is None else term_name

        # device-side state, built lazily
        self._eff_codes_dev: Optional[jax.Array] = None
        self._plan: Optional[SegmentPlan] = None
        # weak keys: a plan dies with the matrix it was built against
        # (an id()-keyed dict returns stale plans after address reuse)
        self._cross_plans = weakref.WeakKeyDictionary()
        self.x_csc = None  # API-parity attribute

    __array_ufunc__ = None

    def __getstate__(self):
        """Pickle only host state; device plans rebuild lazily on load."""
        state = self.__dict__.copy()
        state["_eff_codes_dev"] = None
        state["_plan"] = None
        state["_cross_plans"] = None  # WeakKeyDictionary is not picklable
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._cross_plans = weakref.WeakKeyDictionary()

    # -- lazy device state -------------------------------------------------

    @property
    def _eff_codes_np(self) -> np.ndarray:
        """Effective codes: indices shifted by drop_first; <0 means no entry."""
        if self.drop_first:
            return self.indices.astype(np.int64) - 1
        return self.indices.astype(np.int64)

    @property
    def eff_codes(self) -> jax.Array:
        """Device int32 effective-code vector."""
        if self._eff_codes_dev is None:
            self._eff_codes_dev = jnp.asarray(
                self._eff_codes_np.astype(np.int32)
            )
        return self._eff_codes_dev

    @property
    def plan(self) -> SegmentPlan:
        """Cached SegmentPlan over the effective codes."""
        if self._plan is None:
            self._plan = build_plan(self._eff_codes_np, self.shape[1])
        return self._plan

    # -- core ops ------------------------------------------------------------

    def matvec(self, other, cols: Optional[np.ndarray] = None, out=None):
        """``out[i] (+)= other[codes[i]]`` — a single device gather."""
        check_matvec_out_shape(self, out)
        other_in = other
        other = jnp.asarray(np.asarray(other) if not is_jax_array(other) else other)
        if other.ndim > 1:
            raise NotImplementedError(
                "CategoricalMatrix.matvec is only implemented for 1d arrays."
            )
        check_matvec_dimensions(self, other, transpose=False)

        is_int = np.issubdtype(np.dtype(other.dtype), np.signedinteger)
        if is_int:
            other = other.astype(self.dtype)

        if cols is not None and len(cols) < self.shape[1]:
            cmask = np.zeros(self.shape[1], dtype=np.dtype(other.dtype))
            cmask[np.asarray(cols)] = 1
            other = other * jnp.asarray(cmask)

        res = categorical_ops.take_matvec(self.eff_codes, other)
        if is_int:
            res = res.astype(np.int64 if np.dtype(self.dtype) == np.float64 else np.int32)
        if out is None:
            return result_like(other_in, res)
        return add_into_out(out, res)

    def transpose_matvec(
        self,
        vec,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
        out=None,
    ):
        """``out[c] (+)= Σ_{i in rows, codes[i]=c} vec[i]`` — segment-sum."""
        vec_in = vec
        vec = jnp.asarray(np.asarray(vec) if not is_jax_array(vec) else vec)
        check_matvec_dimensions(self, vec, transpose=True)
        if vec.ndim > 1:
            raise NotImplementedError(
                "CategoricalMatrix.transpose_matvec is only implemented for 1d arrays."
            )
        out_is_none = out is None
        if not out_is_none:
            check_transpose_matvec_out_shape(self, out)

        mask = rows_to_mask(
            None if rows is None else np.asarray(rows),
            self.shape[0],
            np.dtype(vec.dtype),
        )
        vals = vec if mask is None else categorical_ops.masked_values(vec, jnp.asarray(mask))
        res_full = self.plan.sum(vals)

        cols_np = None
        if cols is not None:
            cols_np = set_up_rows_or_cols(cols, self.shape[1])

        if out_is_none:
            if cols_np is not None:
                return result_like(
                    vec_in, jnp.take(res_full, jnp.asarray(cols_np), axis=0)
                )
            return result_like(vec_in, res_full)

        if isinstance(out, np.ndarray):
            res_np = np.asarray(res_full)
            if cols_np is not None and len(cols_np) < self.shape[1]:
                out[cols_np] += res_np[cols_np].astype(out.dtype)
            else:
                out += res_np.astype(out.dtype)
            return out
        # jax out: full-length contribution, optionally masked to cols
        if cols_np is not None and len(cols_np) < self.shape[1]:
            cmask = np.zeros(self.shape[1], dtype=np.dtype(res_full.dtype))
            cmask[cols_np] = 1
            res_full = res_full * jnp.asarray(cmask)
        return out + res_full.astype(out.dtype)

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ) -> DiagonalResult:
        """Diagonal sandwich: ``diag(Σ_{i in rows, codes[i]=c} d[i])``.

        Returns a :class:`DiagonalResult` (device-resident diagonal); use
        ``.to_scipy()`` for a ``scipy.sparse.dia_matrix``.
        """
        d_in = d
        d = jnp.asarray(np.asarray(d) if not is_jax_array(d) else d)
        check_sandwich_compatible(self, d)

        mask = rows_to_mask(
            None if rows is None else np.asarray(rows),
            self.shape[0],
            np.dtype(d.dtype),
        )
        vals = d if mask is None else categorical_ops.masked_values(d, jnp.asarray(mask))
        diag = self.plan.sum(vals)
        from ..utils.validation import is_identity_index

        if not is_identity_index(cols, self.shape[1]):
            diag = jnp.take(diag, jnp.asarray(np.asarray(cols, dtype=np.int32)))
        if not is_jax_array(d_in):
            return DiagonalResult(np.asarray(diag))
        return DiagonalResult(diag)

    # -- cross sandwiches (used by SplitMatrix) ------------------------------

    def _cross_sandwich(
        self,
        other,
        d,
        rows: Optional[np.ndarray] = None,
        L_cols: Optional[np.ndarray] = None,
        R_cols: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """``X[:, L_cols].T @ diag(d) @ other[:, R_cols]``."""
        from .dense import DenseMatrix
        from .sparse import SparseMatrix

        if isinstance(other, DenseMatrix):
            return self._cross_dense(other, d, rows, L_cols, R_cols)
        if isinstance(other, SparseMatrix):
            return self._cross_sparse(other, d, rows, L_cols, R_cols)
        if isinstance(other, CategoricalMatrix):
            return self._cross_categorical(other, d, rows, L_cols, R_cols)
        raise TypeError

    def _cross_dense(self, other, d, rows, L_cols, R_cols) -> np.ndarray:
        """cat.T @ diag(d) @ dense: segment-sum of d-scaled dense rows."""
        B = other.unpack() if hasattr(other, "unpack") else jnp.asarray(other)
        d_dev = jnp.asarray(np.asarray(d) if not is_jax_array(d) else d)

        mask = rows_to_mask(
            None if rows is None else np.asarray(rows),
            self.shape[0],
            np.dtype(d_dev.dtype),
        )
        dm = d_dev if mask is None else d_dev * jnp.asarray(mask)
        if R_cols is not None and len(R_cols) < B.shape[1]:
            B = jnp.take(B, jnp.asarray(np.asarray(R_cols, dtype=np.int32)), axis=1)
        scaled = B * dm[:, None]
        res = self.plan.sum2d(scaled)  # (K, |R_cols|)
        res = np.asarray(res)
        if L_cols is not None and len(L_cols) < self.shape[1]:
            res = res[np.asarray(L_cols)]
        return res

    # Above this, the cross plan compresses to observed pairs instead of
    # allocating K1*K2 segment bounds.
    _CROSS_DENSE_PLAN_MAX = 1 << 24

    def _cross_categorical(self, other, d, rows, L_cols, R_cols) -> np.ndarray:
        """cat.T @ diag(d) @ cat: segment-sum of d over combined codes.

        Small products get a direct K1·K2-segment plan; large products use a
        compressed plan over the *observed* code pairs (≤ n of them) so
        memory stays O(n + K1·K2-output) instead of O(K1·K2) bounds.
        """
        K1, K2 = self.shape[1], other.shape[1]
        if K1 * K2 > 2**31:
            raise MemoryError(
                f"cat × cat cross-sandwich output would have {K1}×{K2} "
                "entries; this is infeasible to densify."
            )
        cached = self._cross_plans.get(other)
        if cached is None:
            e1, e2 = self._eff_codes_np, other._eff_codes_np
            from .. import _native

            combined = _native.combine_codes(
                e1.astype(np.int32, copy=False),
                e2.astype(np.int32, copy=False),
                K2,
            )
            if K1 * K2 <= self._CROSS_DENSE_PLAN_MAX:
                plan = build_plan(combined, K1 * K2)
                uniq = None
            else:
                uniq, inverse = np.unique(combined, return_inverse=True)
                plan = build_plan(inverse.astype(np.int64), len(uniq))
            cached = (plan, uniq)
            self._cross_plans[other] = cached
        plan, uniq = cached

        d_dev = jnp.asarray(np.asarray(d) if not is_jax_array(d) else d)
        mask = rows_to_mask(
            None if rows is None else np.asarray(rows),
            self.shape[0],
            np.dtype(d_dev.dtype),
        )
        vals = d_dev if mask is None else d_dev * jnp.asarray(mask)
        sums_dev = plan.sum(vals)
        if uniq is None:
            res = np.asarray(sums_dev).reshape(K1, K2)
        elif is_jax_array(d):
            # jax path stays device-resident: densify the observed pairs
            # with one structural scatter instead of downloading the sums
            # (~8 MB + a host scatter per call — measured 0.73 s vs 162 ms
            # scipy for two 1k-categoricals at 1M rows; the device route
            # runs in tens of ms)
            valid = uniq >= 0
            idx = jnp.asarray(uniq[valid].astype(np.int64))
            res_dev = (
                jnp.zeros((K1 * K2,), dtype=sums_dev.dtype)
                .at[idx]
                .set(sums_dev[: len(uniq)][jnp.asarray(np.flatnonzero(valid))])
                .reshape(K1, K2)
            )
            if L_cols is not None and len(L_cols) < K1:
                res_dev = jnp.take(res_dev, jnp.asarray(np.asarray(L_cols)), axis=0)
            if R_cols is not None and len(R_cols) < K2:
                res_dev = jnp.take(res_dev, jnp.asarray(np.asarray(R_cols)), axis=1)
            return res_dev
        else:
            sums = np.asarray(sums_dev)
            res = np.zeros((K1, K2), dtype=sums.dtype)
            valid = uniq >= 0
            res[uniq[valid] // K2, uniq[valid] % K2] = sums[valid]
        if L_cols is not None and len(L_cols) < K1:
            res = res[np.asarray(L_cols)]
        if R_cols is not None and len(R_cols) < K2:
            res = res[:, np.asarray(R_cols)]
        return res

    def _cross_sparse(self, other, d, rows, L_cols, R_cols) -> np.ndarray:
        """cat.T @ diag(d) @ sparse via host scipy (small cross block)."""
        from scipy import sparse as sps

        term_1 = self.multiply(np.asarray(d)).unpack().tocsc()
        other_csc = other.unpack() if hasattr(other, "unpack") else sps.csc_matrix(other)

        def _ix(arr, r, c):
            if r is not None and len(r) < arr.shape[0]:
                arr = arr[np.asarray(r)]
            if c is not None and len(c) < arr.shape[1]:
                arr = arr[:, np.asarray(c)]
            return arr

        term_1 = _ix(term_1, rows, L_cols)
        res = term_1.T.dot(_ix(other_csc, rows, R_cols)).toarray()
        return res

    # -- conversions ----------------------------------------------------------

    def getcol(self, i: int):
        """Column ``i`` as a single-column SparseMatrix (wrap-around index).

        Built from the *effective* codes (drop_first shift and missing mask
        already folded in), so one indicator comparison covers every config.
        """
        from scipy import sparse as sps

        from .sparse import SparseMatrix

        i = int(i) % self.shape[1]
        hits = np.flatnonzero(self._eff_codes_np == i)
        col_i = sps.csc_matrix(
            (
                np.ones(hits.size, dtype=int),
                (hits, np.zeros(hits.size, dtype=np.int32)),
            ),
            shape=(self.shape[0], 1),
        )
        return SparseMatrix(
            col_i,
            column_names=[self.column_names[i]],
            term_names=[self.term_names[i]],
        )

    def tocsr(self):
        """scipy CSR representation (host)."""
        from scipy import sparse as sps

        eff = self._eff_codes_np
        valid = eff >= 0
        if valid.all():
            return sps.csr_matrix(
                (
                    np.ones(self.shape[0], dtype=int),
                    eff.astype(np.int32),
                    np.arange(self.shape[0] + 1, dtype=int),
                ),
                shape=self.shape,
            )
        nnz = int(valid.sum())
        indptr = np.zeros(self.shape[0] + 1, dtype=int)
        np.cumsum(valid, out=indptr[1:])
        return sps.csr_matrix(
            (np.ones(nnz, dtype=int), eff[valid].astype(np.int32), indptr),
            shape=self.shape,
        )

    def to_sparse_matrix(self):
        """Convert to a tabmat-tpu SparseMatrix."""
        from .sparse import SparseMatrix

        return SparseMatrix(
            self.tocsr(),
            column_names=self.column_names,
            term_names=self.term_names,
        )

    def toarray(self) -> np.ndarray:
        """Densify to host numpy (in the matrix's float dtype)."""
        return self.tocsr().toarray().astype(self.dtype)

    def recover_orig(self) -> np.ndarray:
        """Reconstruct the original category-valued vector (masked where missing).

        Values come straight from the category table; the only question is
        which code (if any) marks a missing entry: the -1 sentinel when raw
        missings were kept, or the appended missing category under
        ``cat_missing_method="convert"``.
        """
        if self._has_missings:
            missing_code = -1
        elif (
            self._missing_method == "convert"
            and self._missing_category in self.categories
        ):
            missing_code = len(self.categories) - 1
        else:
            missing_code = None

        values = self.categories[self.indices]
        if missing_code is None:
            return values
        return np.ma.array(values, mask=self.indices == missing_code)

    @property
    def cat(self):
        """pandas.Categorical view (backward-compat; requires pandas)."""
        warnings.warn(
            "This property will be removed in the next major release.",
            category=DeprecationWarning,
        )
        if pd is None:
            raise ModuleNotFoundError(
                "The `cat` property requires pandas to be installed."
            )
        return pd.Categorical.from_codes(self.indices, categories=self.categories)

    def unpack(self):
        """The pandas.Categorical underlying this matrix."""
        return self.cat

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Change the nominal float dtype (codes are dtype-independent)."""
        self.dtype = np.dtype(dtype)
        return self

    def _get_col_stds(self, weights, col_means) -> np.ndarray:
        """Column stds via E[X²]=E[X] (entries are 0/1)."""
        mean = np.asarray(self.transpose_matvec(np.asarray(weights)))
        variances = mean - np.asarray(col_means) ** 2
        return np.sqrt(np.maximum(variances, 0))

    def multiply(self, other):
        """Row-wise scaling → CSR SparseMatrix (host)."""
        from scipy import sparse as sps

        from .sparse import SparseMatrix

        other = np.squeeze(np.asarray(other))
        if self.shape[0] != other.shape[0]:
            raise ValueError(
                f"Shapes do not match. Expected length of {self.shape[0]}. "
                f"Got {len(other)}."
            )

        eff = self._eff_codes_np
        valid = eff >= 0
        if valid.all():
            return SparseMatrix(
                sps.csr_matrix(
                    (other, eff.astype(np.int32), np.arange(self.shape[0] + 1, dtype=int)),
                    shape=self.shape,
                ),
                column_names=self.column_names,
                term_names=self.term_names,
            )
        indptr = np.zeros(self.shape[0] + 1, dtype=int)
        np.cumsum(valid, out=indptr[1:])
        return SparseMatrix(
            sps.csr_matrix(
                (other[valid], eff[valid].astype(np.int32), indptr),
                shape=self.shape,
            )
        )

    def __getitem__(self, item):
        row, col = _check_indexer(item)
        if _is_indexer_full_length(self.shape[1], col):
            if isinstance(row, np.ndarray):
                row = row.ravel()
            return CategoricalMatrix(
                self.indices[row],
                categories=self.categories,
                drop_first=self.drop_first,
                dtype=self.dtype,
                column_name=self._colname,
                term_name=self._term,
                column_name_format=self._colname_format,
                cat_missing_method=self._missing_method,
                cat_missing_name=self._missing_category,
            )
        # column subsetting loses the one-nonzero-per-row structure
        return self.to_sparse_matrix()[row, col]

    def __repr__(self):
        return f"{self.__class__.__name__}\nCategories: {self.categories}"

    # -- names ------------------------------------------------------------------

    def get_names(
        self,
        type: str = "column",
        missing_prefix: Optional[str] = None,
        indices: Optional[list[int]] = None,
    ) -> list[Optional[str]]:
        """One formatted name per category (or the single term name)."""
        if type == "column":
            name = self._colname
        elif type == "term":
            name = self._term
        else:
            raise ValueError(f"Type must be 'column' or 'term', got {type}")

        if indices is None:
            indices = list(range(len(self.categories) - self.drop_first))
        if name is None and missing_prefix is None:
            return [None] * (len(self.categories) - self.drop_first)
        elif name is None:
            name = f"{missing_prefix}{indices[0]}-{indices[-1]}"

        if type == "column":
            return [
                self._colname_format.format(name=name, category=cat)
                for cat in self.categories[self.drop_first :]
            ]
        return [name] * (len(self.categories) - self.drop_first)

    def _strip_category_decoration(self, formatted, category):
        """Invert ``_colname_format`` for one column: recover the name field.

        The format template is split around its ``{name}`` placeholder into a
        literal prefix/suffix pair; a formatted column name that carries both
        has the base name sitting in between.  No regexes needed.
        """
        if formatted is None:
            return None
        template = self._colname_format.format(name="\x00", category=category)
        prefix, sep, suffix = template.partition("\x00")
        if not sep:
            return formatted  # format has no {name} field: nothing to strip
        if (
            len(formatted) >= len(prefix) + len(suffix)
            and formatted.startswith(prefix)
            and formatted.endswith(suffix)
        ):
            return formatted[len(prefix) : len(formatted) - len(suffix)]
        return formatted

    def set_names(self, names, type: str = "column"):
        """Set the single base name (parses formatted names back if needed)."""
        attr = {"column": "_colname", "term": "_term"}.get(type)
        if attr is None:
            raise ValueError(f"Type must be 'column' or 'term', got {type}")

        if isinstance(names, str):
            names = [names]
        names = list(names)

        if len(names) > 1:
            # per-column spellings: undo the category decoration, then
            # collapse if one base name covers every column
            if type == "column":
                names = [
                    self._strip_category_decoration(nm, cat)
                    for nm, cat in zip(
                        names, self.categories[self.drop_first :]
                    )
                ]
            if len(names) == self.shape[1] and len(set(names)) == 1:
                names = names[:1]

        if len(names) != 1:
            raise ValueError("A categorical matrix has only one name")
        setattr(self, attr, names[0])
