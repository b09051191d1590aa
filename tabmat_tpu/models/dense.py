"""DenseMatrix: a device-resident dense matrix with the MatrixBase API.

Parity target: reference ``tabmat/dense_matrix.py:24-347``.  Instead of
wrapping a contiguous numpy array and dispatching to C++ kernels, this class
owns a ``jax.Array`` in device memory and dispatches to the jitted kernels
in ``tabmat_tpu.ops.dense_ops``.  Contiguity is irrelevant on device, so any
numpy layout is accepted without copies or warnings.
"""

import textwrap
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dense_ops
from ..utils import (
    _check_indexer,
    add_into_out,
    check_matvec_dimensions,
    check_matvec_out_shape,
    check_sandwich_compatible,
    check_transpose_matvec_out_shape,
    cols_to_mask,
    is_jax_array,
    result_like,
    rows_to_mask,
    set_up_rows_or_cols,
)
from ..utils.validation import is_identity_index
from .base import MatrixBase


class DenseMatrix(MatrixBase):
    """A dense matrix stored in device memory.

    Supports the full MatrixBase contract: ``sandwich``,
    ``matvec``/``transpose_matvec`` with active-set restriction, column
    standardization statistics, names, and indexing.

    Examples
    --------
    >>> import numpy as np, tabmat_tpu as tm
    >>> X = tm.DenseMatrix(np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]))
    >>> X.shape
    (3, 2)
    >>> np.asarray(X.matvec(np.array([1.0, 10.0])))
    array([21., 43., 65.])
    >>> np.asarray(X.sandwich(np.array([1.0, 1.0, 1.0])))
    array([[35., 44.],
           [44., 56.]])
    """

    def __init__(self, input_array, column_names=None, term_names=None):
        if isinstance(input_array, (jax.Array,)):
            arr = input_array
        else:
            arr = jnp.asarray(np.asarray(input_array))

        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        elif arr.ndim > 2:
            raise ValueError("Input array must be 1- or 2-dimensional")

        self._array = arr
        width = arr.shape[1]

        if column_names is not None:
            if len(column_names) != width:
                raise ValueError(
                    f"Expected {width} column names, got {len(column_names)}"
                )
            self._colnames = list(column_names)
        else:
            self._colnames = [None] * width

        if term_names is not None:
            if len(term_names) != width:
                raise ValueError(f"Expected {width} term names, got {len(term_names)}")
            self._terms = list(term_names)
        else:
            self._terms = self._colnames

    # -- array protocol ------------------------------------------------

    __array_ufunc__ = None

    @property
    def shape(self):
        """(n_rows, n_cols)."""
        return tuple(self._array.shape)

    @property
    def ndim(self):
        """Always 2 after construction."""
        return self._array.ndim

    @property
    def dtype(self):
        """Element dtype (numpy dtype object)."""
        return np.dtype(self._array.dtype)

    def transpose(self):
        """Transposed copy as a DenseMatrix."""
        return type(self)(self._array.T)

    T = property(transpose)

    def __matmul__(self, other):
        return result_like(other, dense_ops.matmul(self._array, jnp.asarray(other)))

    def __rmatmul__(self, other):
        return result_like(other, dense_ops.matmul(jnp.asarray(other), self._array))

    def __str__(self):
        return "{}x{} DenseMatrix:\n\n".format(*self.shape) + np.array_str(
            np.asarray(self._array)
        )

    def __repr__(self):
        class_name = type(self).__name__
        array_str = f"{class_name}({np.array2string(np.asarray(self._array), separator=', ')})"
        return textwrap.indent(
            array_str,
            " " * (len(class_name) + 1),
            predicate=lambda line: not line.startswith(class_name),
        )

    def __getitem__(self, key):
        row, col = _check_indexer(key)
        colnames = np.array(self.column_names, dtype=object)[col].ravel().tolist()
        terms = np.array(self.term_names, dtype=object)[col].ravel().tolist()

        # Stay on device for the common one-axis cases (gathers); fall back
        # to host numpy for full fancy (row, col) meshes.
        full = slice(None, None, None)
        if isinstance(row, slice) and row == full and isinstance(col, np.ndarray):
            sub = jnp.take(self._array, jnp.asarray(col.astype(np.int32)), axis=1)
        elif isinstance(col, slice) and col == full and isinstance(row, np.ndarray):
            sub = jnp.take(self._array, jnp.asarray(row.astype(np.int64)), axis=0)
        elif isinstance(row, slice) and isinstance(col, slice):
            sub = self._array[row, col]
        else:
            sub = np.asarray(self._array)[row, col]
        return type(self)(sub, column_names=colnames, term_names=terms)

    def getcol(self, i):
        """Column ``i`` as a (n, 1) DenseMatrix."""
        return type(self)(
            self._array[:, [i]],
            column_names=[self.column_names[i]],
            term_names=[self.term_names[i]],
        )

    def toarray(self) -> np.ndarray:
        """Host numpy copy."""
        return np.asarray(self._array)

    def unpack(self):
        """The underlying ``jax.Array``."""
        return self._array

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Cast to ``dtype`` (order/casting accepted for API parity)."""
        return type(self)(
            self._array.astype(dtype),
            column_names=self.column_names,
            term_names=self.term_names,
        )

    def multiply(self, other):
        """Row-wise (1-d ``other``) or elementwise (2-d) scaling."""
        other_arr = jnp.asarray(np.asarray(other))
        if other_arr.ndim == 1:
            other_arr = other_arr[:, None]
        return type(self)(
            self._array * other_arr,
            column_names=self.column_names,
            term_names=self.term_names,
        )

    # -- core ops --------------------------------------------------------

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ):
        """``X[rows, cols].T @ diag(d[rows]) @ X[rows, cols]``."""
        d_in = d
        d = jnp.asarray(np.asarray(d) if not is_jax_array(d) else d)
        check_sandwich_compatible(self, d)

        mask = rows_to_mask(
            None if rows is None else np.asarray(rows), self.shape[0], self.dtype
        )
        cols_np = None
        if not is_identity_index(cols, self.shape[1]):
            cols_np = np.asarray(cols)

        S, k = dense_ops.sandwich_restricted(
            self._array,
            d,
            None if mask is None else jnp.asarray(mask),
            cols_np,
        )
        if is_jax_array(d_in):
            return S[:k, :k] if S.shape[0] != k else S
        out = np.asarray(S)
        return out[:k, :k] if out.shape[0] != k else out

    def _cross_sandwich(
        self,
        other,
        d,
        rows: Optional[np.ndarray] = None,
        L_cols: Optional[np.ndarray] = None,
        R_cols: Optional[np.ndarray] = None,
    ):
        """Cross-sandwich ``X[:, L_cols].T @ diag(d) @ other[:, R_cols]``."""
        from .categorical import CategoricalMatrix
        from .sparse import SparseMatrix

        if isinstance(other, (SparseMatrix, CategoricalMatrix)):
            return other._cross_sandwich(self, d, rows, R_cols, L_cols).T
        raise TypeError

    def _get_col_stds(self, weights, col_means) -> np.ndarray:
        """Weighted column standard deviations (shifted, robust form)."""
        sqrt_arg = np.array(
            dense_ops.transpose_square_dot_weights(
                self._array,
                jnp.asarray(np.asarray(weights), dtype=self.dtype),
                jnp.asarray(np.asarray(col_means), dtype=self.dtype),
            )
        )
        # tiny negative values can appear from floating point error
        sqrt_arg[sqrt_arg < 0] = 0
        return np.sqrt(sqrt_arg)

    def _matvec_helper(self, vec, rows, cols, out, transpose: bool):
        vec_in = vec
        vec = jnp.asarray(np.asarray(vec) if not is_jax_array(vec) else vec)
        check_matvec_dimensions(self, vec, transpose=transpose)

        n, k = self.shape
        unrestricted_rows = rows is None or len(rows) == n
        # matvec sums over the cols SET (order-free); transpose_matvec's
        # output is ORDERED by cols, so it needs the identity check
        unrestricted_cols = (
            is_identity_index(cols, k) if transpose
            else cols is None or len(cols) == k
        )

        if transpose:
            v_eff = vec
            if not unrestricted_rows:
                mask = rows_to_mask(np.asarray(rows), n, vec.dtype)
                m = jnp.asarray(mask)
                v_eff = vec * (m if vec.ndim == 1 else m[:, None])
            res_full = dense_ops.transpose_matvec(self._array, v_eff)
            if unrestricted_cols:
                res = res_full
                if out is None:
                    return result_like(vec_in, res)
                return add_into_out(out, res)
            cols_np = set_up_rows_or_cols(cols, k)
            if out is None:
                return result_like(vec_in, jnp.take(res_full, jnp.asarray(cols_np), axis=0))
            if isinstance(out, np.ndarray):
                out[cols_np] += np.asarray(
                    jnp.take(res_full, jnp.asarray(cols_np), axis=0), dtype=out.dtype
                )
                return out
            # jax out: add the full-length masked contribution
            cmask = jnp.asarray(cols_to_mask(cols_np, k, np.dtype(res_full.dtype)))
            scaled = res_full * (cmask if res_full.ndim == 1 else cmask[:, None])
            return out + scaled.astype(out.dtype)
        else:
            # matvec: only column restriction is supported by the contract;
            # it is equivalent to zeroing the unselected entries of vec.
            v_eff = vec
            if not unrestricted_cols:
                cmask = jnp.asarray(
                    cols_to_mask(np.asarray(cols), k, np.dtype(vec.dtype))
                )
                v_eff = vec * (cmask if vec.ndim == 1 else cmask[:, None])
            res = dense_ops.matvec(self._array, v_eff)
            if out is None:
                return result_like(vec_in, res)
            return add_into_out(out, res)

    def matvec(self, vec, cols: Optional[np.ndarray] = None, out=None):
        """``X[:, cols] @ vec[cols]``."""
        check_matvec_out_shape(self, out)
        return self._matvec_helper(vec, None, cols, out, False)

    def transpose_matvec(
        self,
        vec,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
        out=None,
    ):
        """``X[rows, cols].T @ vec[rows]``."""
        check_transpose_matvec_out_shape(self, out)
        return self._matvec_helper(vec, rows, cols, out, True)

    # -- names -----------------------------------------------------------

    def get_names(
        self,
        type: str = "column",
        missing_prefix: Optional[str] = None,
        indices: Optional[list[int]] = None,
    ) -> list[Optional[str]]:
        """Column/term names with optional default-name generation."""
        if type == "column":
            names = np.array(self._colnames, dtype=object)
        elif type == "term":
            names = np.array(self._terms, dtype=object)
        else:
            raise ValueError(f"Type must be 'column' or 'term', got {type}")

        if indices is None:
            indices = list(range(len(self._colnames)))
        if missing_prefix is not None:
            defaults = np.array(
                [f"{missing_prefix}{i}" for i in indices], dtype=object
            )
            missing = np.array([nm is None for nm in names.tolist()])
            names[missing] = defaults[missing]
        return names.tolist()

    def set_names(self, names, type: str = "column"):
        """Set column/term names (must match the column count)."""
        if isinstance(names, str):
            names = [names]
        if len(names) != self.shape[1]:
            raise ValueError(f"Length of names must be {self.shape[1]}")
        if type == "column":
            self._colnames = list(names)
        elif type == "term":
            self._terms = list(names)
        else:
            raise ValueError(f"Type must be 'column' or 'term', got {type}")
