"""StandardizedMatrix: a virtual shift/scale view over any MatrixBase.

Parity target: reference ``tabmat/standardized_mat.py:18-379``.  The view is
``self[i, j] = mult[j] * mat[i, j] + shift[j]`` and is never densified:
every op expands into the inner matrix's op plus rank-1 corrections —

sandwich:  ``S = M ∘ (mat.sandwich)  +  outer(mult*t, shift)
            + outer(shift, mult*t)  +  outer(shift, shift) * sum(d)``
where ``t = mat.transpose_matvec(d)`` and ``M = outer(mult, mult)``
(see the derivation at reference ``standardized_mat.py:133-172``).

The rank-1 algebra runs in numpy or jnp depending on the caller's array
flavor; inner-matrix ops run on device either way.
"""

from typing import Optional, Union

import jax.numpy as jnp
import numpy as np

from ..ops import dense_ops
from ..ops.diag import DiagonalResult
from ..utils import (
    check_matvec_dimensions,
    check_sandwich_compatible,
    check_transpose_matvec_out_shape,
    is_identity_index,
    is_jax_array,
    set_up_rows_or_cols,
    setup_restrictions,
)
from .base import MatrixBase


def _is_diag(x) -> bool:
    if isinstance(x, DiagonalResult):
        return True
    try:
        from scipy import sparse as sps

        return isinstance(x, sps.dia_matrix)
    except ImportError:  # pragma: no cover
        return False


def _diag_data(x) -> np.ndarray:
    if isinstance(x, DiagonalResult):
        return np.asarray(x.diag)
    return np.asarray(x.data[0, :])


class StandardizedMatrix:
    """Shift/scale view: ``self[i, j] = mult[j] * mat[i, j] + shift[j]``."""

    __array_priority__ = 11

    def __init__(self, mat: MatrixBase, shift, mult=None):
        shift_arr = np.atleast_1d(np.squeeze(np.asarray(shift)))
        expected_shape = (mat.shape[1],)
        if not isinstance(mat, MatrixBase):
            raise TypeError("mat should be an instance of a MatrixBase subclass.")
        if shift_arr.shape != expected_shape:
            raise ValueError(
                f"Expected shift to conform to shape {expected_shape}, "
                f"but it has shape {np.asarray(shift).shape}"
            )
        if mult is not None:
            mult_arr = np.atleast_1d(np.squeeze(np.asarray(mult)))
            if mult_arr.shape != expected_shape:
                raise ValueError(
                    f"Expected mult to conform to shape {expected_shape}, "
                    f"but it has shape {np.asarray(mult).shape}"
                )
        else:
            mult_arr = None

        self.shift = shift_arr
        self.mult = mult_arr
        self.mat = mat
        self.shape = mat.shape
        self.ndim = mat.ndim
        self.dtype = mat.dtype
        # lazily-built device mirrors of shift/mult: a fresh
        # ``jnp.asarray(numpy)`` per call is a new host->device upload,
        # which serializes the otherwise-async op chain
        self._shift_dev = None
        self._mult_dev = None

    def _device_shift(self):
        if self._shift_dev is None:
            self._shift_dev = jnp.asarray(self.shift)
        return self._shift_dev

    def _device_mult(self):
        if self.mult is not None and self._mult_dev is None:
            self._mult_dev = jnp.asarray(self.mult)
        return self._mult_dev

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_shift_dev"] = None
        state["_mult_dev"] = None
        return state

    # -- core ops --------------------------------------------------------

    def matvec(self, other_mat, cols: Optional[np.ndarray] = None, out=None):
        """``self[:, cols] @ other[cols]`` (dense output)."""
        other_in = other_mat
        xp = jnp if is_jax_array(other_in) else np
        other_mat = other_in if is_jax_array(other_in) else np.asarray(other_in)
        check_matvec_dimensions(self, other_mat, transpose=False)

        k = self.shape[1]
        full_cols = cols is None or len(np.asarray(cols)) == k
        cols = None if full_cols else set_up_rows_or_cols(cols, k)

        shift = self._device_shift() if xp is jnp else self.shift
        mult = (self._device_mult() if xp is jnp else self.mult)

        mult_other = other_mat
        if mult is not None:
            for _ in range(other_mat.ndim - 1):
                mult = mult[:, None]
            mult_other = mult * other_mat

        mat_part = self.mat.matvec(mult_other, cols, out=out)
        if full_cols:
            shift_part = (dense_ops.matmul if xp is jnp else np.dot)(shift, other_mat)
        elif xp is jnp:
            ci = jnp.asarray(cols)
            shift_part = dense_ops.matmul(
                jnp.take(shift, ci), jnp.take(other_mat, ci, axis=0)
            )
        else:
            shift_part = shift[cols].dot(other_mat[cols, ...])
        if isinstance(mat_part, np.ndarray) and mat_part.flags.writeable:
            mat_part += np.asarray(shift_part)
            return mat_part
        return mat_part + shift_part

    def transpose_matvec(
        self,
        other,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
        out=None,
    ):
        """``self[rows, cols].T @ other[rows]``.

        The shift contributes ``outer(shift[cols], other[rows].sum(0))`` —
        see the derivation at reference ``standardized_mat.py:185-204``.
        """
        check_transpose_matvec_out_shape(self, out)
        other_in = other
        xp = jnp if is_jax_array(other_in) else np
        other = other_in if is_jax_array(other_in) else np.asarray(other_in)
        check_matvec_dimensions(self, other, transpose=True)

        res = self.mat.transpose_matvec(other, rows, cols)
        res = res if is_jax_array(res) else np.asarray(res)

        rows_idx, cols_idx = setup_restrictions(self.shape, rows, cols)
        # output is ORDERED by cols, so only the true identity skips gathers
        full_cols = is_identity_index(cols, self.shape[1])
        if rows is None or len(rows_idx) == self.shape[0]:
            other_sum = xp.sum(other, 0)  # avoid the O(n) identity gather
        elif xp is jnp:
            other_sum = jnp.sum(jnp.take(other, jnp.asarray(rows_idx), axis=0), 0)
        else:
            other_sum = np.sum(other[rows_idx], 0)

        shift = self._device_shift() if xp is jnp else self.shift
        if full_cols:
            shift_lim = shift
        elif xp is jnp:
            shift_lim = jnp.take(shift, jnp.asarray(cols_idx))
        else:
            shift_lim = shift[cols_idx]
        shift_part_tmp = xp.outer(shift_lim, other_sum)
        output_shape = (
            (self.shape[1] if cols is None else len(cols_idx)),
        ) + tuple(res.shape[1:])
        shift_part = xp.reshape(shift_part_tmp, output_shape)

        if self.mult is not None:
            mult = self._device_mult() if xp is jnp else self.mult
            if full_cols:
                mult_lim = mult
            elif xp is jnp:
                mult_lim = jnp.take(mult, jnp.asarray(cols_idx))
            else:
                mult_lim = mult[cols_idx]
            for _ in range(res.ndim - 1):
                mult_lim = mult_lim[:, None]
            res = res * mult_lim
        res = res + shift_part

        if out is None:
            return res
        if isinstance(out, np.ndarray):
            out[cols_idx] += np.asarray(res, dtype=out.dtype)
            return out
        # jax out: scatter-free accumulation over the restricted columns via
        # a host-precomputed gather map (missing positions hit a zero slot)
        if cols is None or len(cols_idx) == self.shape[1]:
            return out + res
        index_map = np.full(out.shape[0], len(cols_idx), dtype=np.int64)
        index_map[np.asarray(cols_idx)] = np.arange(len(cols_idx))
        res_flat = jnp.reshape(res, (len(cols_idx),) + tuple(res.shape[1:]))
        padded = jnp.concatenate(
            [res_flat, jnp.zeros((1,) + tuple(res_flat.shape[1:]), res_flat.dtype)]
        )
        return out + jnp.take(padded, jnp.asarray(index_map), axis=0).astype(out.dtype)

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Four-term expansion of the standardized sandwich (host assembly)."""
        if not hasattr(d, "dtype"):
            d = np.asarray(d)
        check_sandwich_compatible(self, d)

        if rows is not None or cols is not None:
            setup_rows, setup_cols = setup_restrictions(self.shape, rows, cols)
            if rows is not None:
                rows = setup_rows
            if cols is not None:
                cols = setup_cols

        # one upload of the weights, shared by the inner sandwich and tmv
        d_dev = d if is_jax_array(d) else jnp.asarray(np.asarray(d))
        term1 = self.mat.sandwich(d_dev, rows, cols)

        if is_jax_array(d) and (
            is_jax_array(term1)
            or (isinstance(term1, DiagonalResult) and is_jax_array(term1.diag))
        ):
            # device caller and device inner result: assemble the rank-1
            # corrections in jnp and return WITHOUT a host download
            return self._sandwich_device(term1, d_dev, rows, cols)

        d_mat = np.asarray(self.mat.transpose_matvec(d_dev, rows, cols))
        if self.mult is not None:
            limited_mult = self.mult[cols] if cols is not None else self.mult
            d_mat = d_mat * limited_mult
        limited_shift = self.shift[cols] if cols is not None else self.shift
        d_np = np.asarray(d)
        limited_d = d_np[np.asarray(rows)] if rows is not None else d_np

        term2 = np.outer(d_mat, limited_shift)
        term3 = np.outer(limited_shift, d_mat)
        term4 = np.outer(limited_shift, limited_shift) * np.sum(limited_d)
        res = term2 + term3 + term4

        if _is_diag(term1):
            idx = np.arange(res.shape[0])
            to_add = _diag_data(term1).copy()
            if self.mult is not None:
                to_add *= limited_mult**2
            res[idx, idx] += to_add
        else:
            to_add = np.asarray(term1)
            if self.mult is not None:
                to_add = to_add * np.outer(limited_mult, limited_mult)
            res += to_add
        return res

    def _sandwich_device(self, term1, d_dev, rows, cols):
        """jnp twin of the 4-term expansion; everything stays on device."""
        d_mat = self.mat.transpose_matvec(d_dev, rows, cols)
        limited_mult = (
            None
            if self.mult is None
            else (
                jnp.asarray(self.mult[cols])
                if cols is not None
                else self._device_mult()
            )
        )
        if limited_mult is not None:
            d_mat = d_mat * limited_mult
        limited_shift = (
            jnp.asarray(self.shift[cols]) if cols is not None else self._device_shift()
        )
        d_sum = (
            jnp.sum(jnp.take(d_dev, jnp.asarray(rows)))
            if rows is not None
            else jnp.sum(d_dev)
        )

        res = (
            jnp.outer(d_mat, limited_shift)
            + jnp.outer(limited_shift, d_mat)
            + jnp.outer(limited_shift, limited_shift) * d_sum
        )
        if isinstance(term1, DiagonalResult):
            diag = term1.diag
            if limited_mult is not None:
                diag = diag * limited_mult**2
            return res + jnp.diag(diag)
        inner = term1
        if limited_mult is not None:
            inner = inner * jnp.outer(limited_mult, limited_mult)
        return res + inner

    # -- conversions / plumbing -------------------------------------------

    def unstandardize(self) -> MatrixBase:
        """Return the inner (unstandardized) matrix."""
        return self.mat

    def getcol(self, i: int):
        """Column ``i`` as a StandardizedMatrix over the inner column."""
        mult = None
        if self.mult is not None:
            mult = [self.mult[i]]
        col = self.mat.getcol(i)
        return StandardizedMatrix(col, [self.shift[i]], mult)

    def toarray(self) -> np.ndarray:
        """Densify: ``mult * mat + shift``."""
        mat_part = self.mat.toarray()
        if self.mult is not None:
            mat_part = self.mult[None, :] * mat_part
        return mat_part + self.shift[None, :]

    @property
    def A(self) -> np.ndarray:
        """Alias for toarray()."""
        return self.toarray()

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Cast the inner matrix and shift."""
        return type(self)(
            self.mat.astype(dtype, casting=casting, copy=copy),
            self.shift.astype(dtype, order=order, casting=casting, copy=copy),
            self.mult if self.mult is None else self.mult.astype(dtype),
        )

    def multiply(self, other):
        """Row-wise scaling (densifies)."""
        from .dense import DenseMatrix

        return DenseMatrix(self.toarray()).multiply(other)

    def __matmul__(self, other):
        return self.matvec(other)

    def __rmatmul__(self, other):
        if not hasattr(other, "T"):
            other = np.asarray(other)
        return self.transpose_matvec(other.T).T

    def __getitem__(self, item):
        if isinstance(item, tuple):
            row, col = item
        else:
            row = item
            col = slice(None, None, None)

        mat_part = self.mat.__getitem__(item)
        shift_part = self.shift[col]
        mult_part = self.mult
        if mult_part is not None:
            mult_part = np.atleast_1d(mult_part[col])

        if isinstance(row, int):
            out = mat_part.toarray()
            if mult_part is not None:
                out = out * mult_part
            return out + shift_part

        return StandardizedMatrix(mat_part, np.atleast_1d(shift_part), mult_part)

    def __repr__(self):
        return (
            f"StandardizedMat. Mat: {type(self.mat)} of shape {self.mat.shape}.\n"
            f"Shift: {self.shift}\nMult: {self.mult}"
        )

    # -- names -------------------------------------------------------------

    def get_names(
        self,
        type: str = "column",
        missing_prefix: Optional[str] = None,
        indices: Optional[list[int]] = None,
    ) -> list[Optional[str]]:
        """Delegate to the inner matrix."""
        return self.mat.get_names(type, missing_prefix, indices)

    def set_names(self, names: Union[str, list[Optional[str]]], type: str = "column"):
        """Delegate to the inner matrix."""
        self.mat.set_names(names, type)

    @property
    def column_names(self):
        """Column names of the inner matrix."""
        return self.get_names(type="column")

    @column_names.setter
    def column_names(self, names):
        self.set_names(names, type="column")

    @property
    def term_names(self):
        """Term names of the inner matrix."""
        return self.get_names(type="term")

    @term_names.setter
    def term_names(self, names):
        self.set_names(names, type="term")
