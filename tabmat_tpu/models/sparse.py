"""SparseMatrix: host CSC container with device CSR/CSC reduction mirrors.

Parity target: reference ``tabmat/sparse_matrix.py:27-407``.  Construction,
slicing, and export stay on the host as ``scipy.sparse.csc_matrix``; the
compute path uploads the structure arrays once and runs the
boundary-segmented cumsum kernels in ``tabmat_tpu.ops.sparse_ops``:

- ``matvec``           → CSR walk (segments = rows)
- ``transpose_matvec`` → CSC walk (segments = columns)
- ``sandwich``         → within-row pair expansion for very sparse designs,
  densified device mirror + dense contraction for GLM-typical widths;
  host scipy SpGEMM fallback for very wide matrices
- cross vs dense       → gather rows of ``d·B`` + column-bounded segment sum
"""

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from scipy import sparse as sps

from ..ops import dense_ops, sparse_ops
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
from ..utils.validation import is_full_length, is_identity_index
from .base import MatrixBase

# Width at which the sandwich stops using the densified device mirror.
DENSE_SANDWICH_MAX_COLS = 4096
# Element budget for the densified mirror (n*k); above this, stay sparse.
DENSE_SANDWICH_MAX_ELEMENTS = 1 << 28
# Pair-expansion sandwich budget: sum(nnz_r^2) pairs and k^2 segments.
PAIR_SANDWICH_MAX_PAIRS = 50_000_000
PAIR_SANDWICH_MAX_SEGMENTS = 1 << 26


from functools import partial


@partial(jax.jit, static_argnames=("k",))
def _pair_sandwich_jit(pairprod_sorted, row_sorted, dm, bounds, k):
    """Pair-expansion sandwich in ONE dispatch.

    ``pairprod_sorted = (data[ia] * data[ib])[perm]`` and
    ``row_sorted = row[perm]`` are construction-time constants, so the
    per-op work is one gather of ``d``, one multiply, one cumsum, and the
    boundary differences.
    """
    vals = pairprod_sorted * jnp.take(dm, row_sorted)
    csum = jnp.cumsum(vals)
    padded = jnp.concatenate([jnp.zeros((1,), dtype=csum.dtype), csum])
    flat = jnp.take(padded, bounds[1:]) - jnp.take(padded, bounds[:-1])
    return flat.reshape(k, k)


def _pair_sandwich_op(pairprod_sorted, row_sorted, dm, bounds, k):
    """Device half of the pair-expansion sandwich."""
    return _pair_sandwich_jit(pairprod_sorted, row_sorted, dm, bounds, k)


class SparseMatrix(MatrixBase):
    """CSC sparse matrix conforming to the MatrixBase interface."""

    def __init__(
        self,
        input_array,
        shape=None,
        dtype=None,
        copy=False,
        column_names=None,
        term_names=None,
    ):
        if isinstance(input_array, np.ndarray):
            if input_array.ndim == 1:
                input_array = input_array.reshape(-1, 1)
            elif input_array.ndim > 2:
                raise ValueError("Input array must be 1- or 2-dimensional")

        self._array = sps.csc_matrix(input_array, shape, dtype, copy)

        self.idx_dtype = max(self._array.indices.dtype, self._array.indptr.dtype)
        if self._array.indices.dtype != self.idx_dtype:
            self._array.indices = self._array.indices.astype(self.idx_dtype)
        if self._array.indptr.dtype != self.idx_dtype:
            self._array.indptr = self._array.indptr.astype(self.idx_dtype)

        if not self._array.has_sorted_indices:
            self._array.sort_indices()
        self._array_csr = None

        if column_names is not None:
            if len(column_names) != self.shape[1]:
                raise ValueError(
                    f"Expected {self.shape[1]} column names, got {len(column_names)}"
                )
            self._colnames = list(column_names)
        else:
            self._colnames = [None] * self.shape[1]

        if term_names is not None:
            if len(term_names) != self.shape[1]:
                raise ValueError(
                    f"Expected {self.shape[1]} term names, got {len(term_names)}"
                )
            self._terms = list(term_names)
        else:
            self._terms = self._colnames

        # lazily-built device mirrors
        self._dev_csr = None
        self._dev_csc = None
        self._dev_dense = None
        self._pair_plan = None  # (plan, ia, ib, row) for the pair sandwich

    def __getstate__(self):
        """Pickle only host state; device mirrors rebuild lazily on load."""
        state = self.__dict__.copy()
        state["_dev_csr"] = None
        state["_dev_csc"] = None
        state["_dev_dense"] = None
        state["_pair_plan"] = None
        state["_array_csr"] = None
        return state

    # -- device mirrors --------------------------------------------------

    def _csr_parts(self):
        """(data, col_idx, row_bounds) on device, built once."""
        if self._dev_csr is None:
            csr = self.array_csr
            self._dev_csr = (
                jnp.asarray(csr.data),
                jnp.asarray(csr.indices.astype(np.int32, copy=False)
                            if csr.indices.dtype != np.int64 else csr.indices),
                jnp.asarray(csr.indptr),
            )
        return self._dev_csr

    def _csc_parts(self):
        """(data, row_idx, col_bounds) on device, built once."""
        if self._dev_csc is None:
            csc = self._array
            self._dev_csc = (
                jnp.asarray(csc.data),
                jnp.asarray(csc.indices.astype(np.int32, copy=False)
                            if csc.indices.dtype != np.int64 else csc.indices),
                jnp.asarray(csc.indptr),
            )
        return self._dev_csc

    def _pair_sandwich_parts(self):
        """Pair-expansion sandwich precompute (built once, or None if too big).

        The sandwich is ``S[i,j] = Σ_r d_r Σ_{(a,b)∈nnz(r)²} data_a data_b``
        keyed by ``(col_a, col_b)`` — a single segment-sum over all within-row
        nonzero pairs.  Feasible when sum(nnz_r²) and k² are bounded; that is
        the typical GLM regime (narrow-ish, very sparse).
        """
        n, k = self.shape
        if self._pair_plan is not None:
            return self._pair_plan if self._pair_plan != () else None
        csr = self.array_csr
        counts = np.diff(csr.indptr)
        n_pairs = int((counts.astype(np.int64) ** 2).sum())
        if n_pairs > PAIR_SANDWICH_MAX_PAIRS or k * k > PAIR_SANDWICH_MAX_SEGMENTS:
            self._pair_plan = ()
            return None
        from .. import _native

        ia, ib, row = _native.expand_pairs_csr(csr.indptr)
        cols = csr.indices
        keys = cols[ia].astype(np.int64) * k + cols[ib]
        if k * k <= (1 << 24):
            perm, bounds = _native.counting_argsort(keys.astype(np.int32), k * k)
        else:
            perm = np.argsort(keys, kind="stable")
            bounds = np.searchsorted(keys[perm], np.arange(k * k + 1))
        # pre-sort and pre-multiply everything structural
        pairprod_sorted = (csr.data[ia] * csr.data[ib])[perm]
        row_sorted = row[perm]
        self._pair_plan = (
            jnp.asarray(pairprod_sorted),
            jnp.asarray(row_sorted),
            jnp.asarray(np.asarray(bounds, dtype=np.int64)),
        )
        return self._pair_plan

    def _dense_mirror(self) -> Optional[jax.Array]:
        """Densified device copy used by the sandwich (GLM-typical widths)."""
        n, k = self.shape
        if k > DENSE_SANDWICH_MAX_COLS or n * k > DENSE_SANDWICH_MAX_ELEMENTS:
            return None
        if self._dev_dense is None:
            from .._config import cache_charge

            if not cache_charge(self.dtype.itemsize * n * k, self):
                return None
            self._dev_dense = jnp.asarray(self._array.toarray())
        return self._dev_dense

    # -- scipy-compatible surface -----------------------------------------

    @property
    def shape(self):
        """(n_rows, n_cols)."""
        return self._array.shape

    @property
    def ndim(self):
        """Always 2."""
        return self._array.ndim

    @property
    def dtype(self):
        """Element dtype."""
        return self._array.dtype

    @property
    def indices(self):
        """CSC row indices."""
        return self._array.indices

    @property
    def indptr(self):
        """CSC column pointers."""
        return self._array.indptr

    @property
    def data(self):
        """CSC nonzero values."""
        return self._array.data

    @property
    def array_csc(self):
        """The underlying CSC matrix."""
        return self._array

    @property
    def array_csr(self):
        """Cached CSR twin."""
        if self._array_csr is None:
            self._array_csr = self._array.tocsr(copy=False)
            if self._array_csr.indices.dtype != self.idx_dtype:
                self._array_csr.indices = self._array_csr.indices.astype(self.idx_dtype)
            if self._array_csr.indptr.dtype != self.idx_dtype:
                self._array_csr.indptr = self._array_csr.indptr.astype(self.idx_dtype)
        return self._array_csr

    def tocsc(self, copy=False):
        """CSC copy/view."""
        return self._array.tocsc(copy=copy)

    def transpose(self):
        """Transposed SparseMatrix."""
        return type(self)(self._array.T)

    T = property(transpose)

    def getcol(self, i):
        """Column ``i`` as a single-column SparseMatrix."""
        return type(self)(
            self._array[:, [i]],
            column_names=[self.column_names[i]],
            term_names=[self.term_names[i]],
        )

    def unpack(self):
        """The underlying scipy CSC matrix."""
        return self._array

    def toarray(self):
        """Densify to host numpy."""
        return self._array.toarray()

    def dot(self, other):
        """scipy dot product."""
        return self._array.dot(other)

    def __matmul__(self, other):
        return self._array.__matmul__(other)

    def __rmatmul__(self, other):
        return self._array.__rmatmul__(other)

    __array_ufunc__ = None

    def __getitem__(self, key):
        row, col = _check_indexer(key)
        colnames = np.array(self.column_names, dtype=object)[col].ravel().tolist()
        terms = np.array(self.term_names, dtype=object)[col].ravel().tolist()
        return type(self)(
            self._array.__getitem__((row, col)),
            column_names=colnames,
            term_names=terms,
        )

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Cast to dtype."""
        return type(self)(self._array.astype(dtype, casting, copy))

    def multiply(self, other):
        """Row-wise (1-d) or elementwise scaling."""
        other = np.asanyarray(other)
        if other.ndim == 1:
            return type(self)(
                self._array.multiply(other[:, np.newaxis]),
                column_names=self.column_names,
                term_names=self.term_names,
            )
        return type(self)(
            self._array.multiply(other),
            column_names=self.column_names,
            term_names=self.term_names,
        )

    # -- core ops -----------------------------------------------------------

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ):
        """``X[rows, cols].T @ diag(d[rows]) @ X[rows, cols]``."""
        d_in = d
        d_np = np.asarray(d) if not is_jax_array(d) else d
        check_sandwich_compatible(self, d_np)

        pair = self._pair_sandwich_parts()
        if pair is not None:
            pairprod_sorted, row_sorted, bounds = pair
            d_dev = jnp.asarray(d_np)
            mask = rows_to_mask(
                None if rows is None else np.asarray(rows), self.shape[0], self.dtype
            )
            dm = d_dev if mask is None else d_dev * jnp.asarray(mask)
            S = _pair_sandwich_op(
                pairprod_sorted, row_sorted, dm, bounds, self.shape[1]
            )
            if not is_identity_index(cols, self.shape[1]):
                c = np.asarray(cols)
                if is_jax_array(d_in):
                    ci = jnp.asarray(c.astype(np.int32))
                    return jnp.take(jnp.take(S, ci, axis=0), ci, axis=1)
                return np.asarray(S)[np.ix_(c, c)]
            return S if is_jax_array(d_in) else np.asarray(S)

        dense = self._dense_mirror()
        if dense is not None:
            d_dev = jnp.asarray(d_np)
            mask = rows_to_mask(
                None if rows is None else np.asarray(rows), self.shape[0], self.dtype
            )
            cols_np = None
            if not is_identity_index(cols, self.shape[1]):
                cols_np = np.asarray(cols)
            S, k = dense_ops.sandwich_restricted(
                dense,
                d_dev,
                None if mask is None else jnp.asarray(mask),
                cols_np,
            )
            if is_jax_array(d_in):
                return S[:k, :k] if S.shape[0] != k else S
            out = np.asarray(S)
            return out[:k, :k] if out.shape[0] != k else out

        # wide fallback: host SpGEMM (scipy), exact
        d_host = np.asarray(d_np)
        mask = rows_to_mask(
            None if rows is None else np.asarray(rows), self.shape[0], d_host.dtype
        )
        dm = d_host if mask is None else d_host * mask
        A = self._array
        if not is_identity_index(cols, self.shape[1]):
            A = A[:, np.asarray(cols)]
        S = (A.T @ A.multiply(dm[:, None])).toarray()
        return S

    def _cross_sandwich(
        self,
        other,
        d,
        rows: Optional[np.ndarray] = None,
        L_cols: Optional[np.ndarray] = None,
        R_cols: Optional[np.ndarray] = None,
    ):
        """``X[:, L_cols].T @ diag(d) @ other[:, R_cols]``."""
        from .categorical import CategoricalMatrix
        from .dense import DenseMatrix

        if isinstance(other, DenseMatrix):
            return self.sandwich_dense(other, d, rows, L_cols, R_cols)
        if isinstance(other, CategoricalMatrix):
            return other._cross_sandwich(self, d, rows, R_cols, L_cols).T
        raise TypeError

    def sandwich_dense(self, B, d, rows, L_cols, R_cols) -> np.ndarray:
        """``self[:, L_cols].T @ diag(d) @ B[:, R_cols]`` (device kernel)."""
        B_dev = B.unpack() if hasattr(B, "unpack") else jnp.asarray(np.asarray(B))
        d_np = np.asarray(d) if not is_jax_array(d) else d
        if np.dtype(self.dtype) != np.dtype(d_np.dtype) or np.dtype(
            B_dev.dtype
        ) != np.dtype(d_np.dtype):
            raise TypeError(
                "self, B and d all need to be of same dtype, either "
                f"np.float64 or np.float32. This matrix is of type {self.dtype}, "
                f"B is of type {B_dev.dtype}, while d is of type {d_np.dtype}."
            )

        d_dev = jnp.asarray(d_np)
        mask = rows_to_mask(
            None if rows is None else np.asarray(rows),
            self.shape[0],
            np.dtype(d_dev.dtype),
        )
        dm = d_dev if mask is None else d_dev * jnp.asarray(mask)
        if R_cols is not None and not is_full_length(R_cols, B_dev.shape[1]):
            B_dev = jnp.take(
                B_dev, jnp.asarray(np.asarray(R_cols, dtype=np.int32)), axis=1
            )
        data, row_idx, col_bounds = self._csc_parts()
        res = np.asarray(sparse_ops.csc_cross_dense(data, row_idx, col_bounds, dm, B_dev))
        if L_cols is not None and not is_full_length(L_cols, self.shape[1]):
            res = res[np.asarray(L_cols)]
        return res

    # nnz ceiling for the host OpenMP walk (numpy callers): the walk
    # streams ~1-2 Gnnz/s across cores, while the device route pays an
    # upload of the vector and a download of the result for host callers
    _HOST_WALK_MAX_NNZ = 32_000_000

    def _host_walk_matvec(self, vec, rows, cols, out, transpose: bool):
        """OpenMP CSR/CSC walk for host-numpy callers (or None).

        The device kernels keep jax callers (jit-composable, no host
        round-trip); a numpy caller at benchmark sizes is better served
        by the native walk — the reference's per-call C path
        (``tabmat/ext/sparse.pyx:129-199``).  Exact f64; honours the
        ``out=`` in-place contract and rows/cols restrictions.
        """
        from .. import _native

        n, k = self.shape
        if (
            vec.ndim != 1
            or np.dtype(self.dtype) != np.float64
            or vec.dtype != np.float64
            or self._array.nnz > self._HOST_WALK_MAX_NNZ
            or (out is not None and not isinstance(out, np.ndarray))
        ):
            return None
        if transpose:
            v_eff = vec
            if rows is not None and not is_full_length(rows, n):
                v_eff = vec * rows_to_mask(np.asarray(rows), n, vec.dtype)
            csc = self._array
            full_cols = is_identity_index(cols, k)
            res_full = _native.csc_tmv(
                csc.data,
                csc.indices,
                csc.indptr,
                k,
                v_eff,
                out=out if full_cols else None,
            )
            if res_full is None:
                return None  # no native lib — use the device routes
            if full_cols:
                return res_full  # out (if given) was accumulated in place
            cols_np = set_up_rows_or_cols(cols, k)
            if out is None:
                return res_full[cols_np]
            out[cols_np] += res_full[cols_np]
            return out
        else:
            if rows is not None and not is_full_length(rows, n):
                # the forward walk has no row filter — fall through to the
                # device path rather than silently dropping the restriction
                return None
            v_eff = vec
            if cols is not None and not is_full_length(cols, k):
                cmask = np.zeros(k, dtype=vec.dtype)
                cmask[np.asarray(cols)] = 1
                v_eff = vec * cmask
            csr = self.array_csr
            return _native.csr_matvec(
                csr.data, csr.indices, csr.indptr, n, v_eff, out=out
            )

    def _matvec_helper(self, vec, rows, cols, out, transpose: bool):
        vec_in = vec
        if not is_jax_array(vec_in):
            vec_np = np.asarray(vec_in)
            check_matvec_dimensions(self, vec_np, transpose)
            host = self._host_walk_matvec(vec_np, rows, cols, out, transpose)
            if host is not None:
                return host
        vec = jnp.asarray(np.asarray(vec) if not is_jax_array(vec) else vec)
        check_matvec_dimensions(self, vec, transpose)

        n, k = self.shape
        if transpose:
            v_eff = vec
            if rows is not None and not is_full_length(rows, n):
                mask = rows_to_mask(np.asarray(rows), n, np.dtype(vec.dtype))
                m = jnp.asarray(mask)
                v_eff = vec * (m if vec.ndim == 1 else m[:, None])
            data, row_idx, col_bounds = self._csc_parts()
            if vec.ndim == 1:
                res_full = sparse_ops.csc_rmatvec(data, row_idx, col_bounds, v_eff)
            else:
                res_full = sparse_ops.csc_rmatmat(data, row_idx, col_bounds, v_eff)
            if is_identity_index(cols, k):
                if out is None:
                    return result_like(vec_in, res_full)
                return add_into_out(out, res_full)
            cols_np = set_up_rows_or_cols(cols, k)
            if out is None:
                return result_like(
                    vec_in, jnp.take(res_full, jnp.asarray(cols_np), axis=0)
                )
            if isinstance(out, np.ndarray):
                out[cols_np] += np.asarray(
                    jnp.take(res_full, jnp.asarray(cols_np), axis=0), dtype=out.dtype
                )
                return out
            cmask = np.zeros(k, dtype=np.dtype(res_full.dtype))
            cmask[cols_np] = 1
            m = jnp.asarray(cmask)
            return out + (res_full * (m if res_full.ndim == 1 else m[:, None])).astype(
                out.dtype
            )
        else:
            v_eff = vec
            if cols is not None and not is_full_length(cols, k):
                cmask = np.zeros(k, dtype=np.dtype(vec.dtype))
                cmask[np.asarray(cols)] = 1
                m = jnp.asarray(cmask)
                v_eff = vec * (m if vec.ndim == 1 else m[:, None])
            data, col_idx, row_bounds = self._csr_parts()
            if vec.ndim == 1:
                res = sparse_ops.csr_matvec(data, col_idx, row_bounds, v_eff)
            else:
                res = sparse_ops.csr_matmat(data, col_idx, row_bounds, v_eff)
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

    def _get_col_stds(self, weights, col_means) -> np.ndarray:
        """Weighted column stds via E[X²] − E[X]² on the CSC structure."""
        w = jnp.asarray(np.asarray(weights))
        data, row_idx, col_bounds = self._csc_parts()
        ex2 = np.asarray(
            sparse_ops.csc_square_dot_weights(data, row_idx, col_bounds, w)
        )
        sqrt_arg = ex2 - np.asarray(col_means) ** 2
        sqrt_arg[sqrt_arg < 0] = 0
        return np.sqrt(sqrt_arg)

    # -- names ------------------------------------------------------------

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
            defaults = np.array([f"{missing_prefix}{i}" for i in indices], dtype=object)
            missing = np.array([nm is None for nm in names.tolist()])
            names[missing] = defaults[missing]
        return names.tolist()

    def set_names(self, names, type: str = "column"):
        """Set column/term names."""
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
