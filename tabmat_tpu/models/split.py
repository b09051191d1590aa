"""SplitMatrix: a column-partitioned container of heterogeneous blocks.

Parity target: reference ``tabmat/split_matrix.py:144-554`` (plus
``as_tabmat``/``hstack``, ``split_matrix.py:22-61``).  A SplitMatrix holds
dense, sparse, and categorical blocks each covering a sorted set of global
column indices; ops fan out to the blocks and the results are assembled:

- ``sandwich``: per-block diagonal blocks + all pairwise cross-sandwiches,
  mirrored into a host (k, k) array (reference ``split_matrix.py:324-356``);
- ``matvec``/``transpose_matvec``: per-block ops; numpy callers get in-place
  indexed accumulation, jax callers get a scatter-free concat+gather
  permutation (`_place_segments`) so the whole pipeline stays on device.

The reference's Cython merge-walk ``split_col_subsets`` becomes a vectorized
numpy searchsorted on the host (column counts are small).
"""

import warnings
from collections.abc import Sequence
from typing import Optional

import jax.numpy as jnp
import numpy as np
from scipy import sparse as sps

from ..ops.diag import DiagonalResult
from ..utils import (
    check_matvec_dimensions,
    check_matvec_out_shape,
    check_sandwich_compatible,
    check_transpose_matvec_out_shape,
    is_full_length,
    is_identity_index,
    is_jax_array,
    set_up_rows_or_cols,
)


def _device_design_sandwich(design, w):
    """One jitted XLA program for the full blockwise sandwich assembly."""
    global _DESIGN_SANDWICH_JIT
    if _DESIGN_SANDWICH_JIT is None:
        import jax

        _DESIGN_SANDWICH_JIT = jax.jit(lambda dd, weights: dd.sandwich(weights))
    return _DESIGN_SANDWICH_JIT(design, w)


def _device_design_matvec(design, v):
    global _DESIGN_MATVEC_JIT
    if _DESIGN_MATVEC_JIT is None:
        import jax

        _DESIGN_MATVEC_JIT = jax.jit(lambda dd, vec: dd.matvec(vec))
    return _DESIGN_MATVEC_JIT(design, v)


def _device_design_tmv(design, r):
    global _DESIGN_TMV_JIT
    if _DESIGN_TMV_JIT is None:
        import jax

        _DESIGN_TMV_JIT = jax.jit(lambda dd, vec: dd.transpose_matvec(vec))
    return _DESIGN_TMV_JIT(design, r)


_DESIGN_SANDWICH_JIT = None
_DESIGN_MATVEC_JIT = None
_DESIGN_TMV_JIT = None
from .base import MatrixBase
from .dense import DenseMatrix
from .sparse import SparseMatrix
from .standardized import StandardizedMatrix


def as_tabmat(a):
    """Coerce to a MatrixBase: sparse → SparseMatrix, ndarray → DenseMatrix."""
    if isinstance(a, (MatrixBase, StandardizedMatrix)):
        return a
    elif sps.issparse(a):
        return SparseMatrix(a.tocsc(copy=False))
    elif isinstance(a, np.ndarray):
        return DenseMatrix(a)
    else:
        try:
            import jax

            if isinstance(a, jax.Array):
                return DenseMatrix(a)
        except ImportError:  # pragma: no cover
            pass
        raise ValueError(f"Cannot convert type {type(a)} to Matrix.")


def hstack(tup: Sequence) -> MatrixBase:
    """Stack matrices horizontally; homogeneous inputs keep their type."""
    matrices = [as_tabmat(a) for a in tup]

    if len(matrices) == 0:
        raise ValueError("Need at least one array to concatenate.")

    if all(isinstance(mat, SparseMatrix) for mat in matrices):
        return SparseMatrix(sps.hstack([mat.unpack() for mat in matrices]))
    elif all(isinstance(mat, DenseMatrix) for mat in matrices):
        return DenseMatrix(jnp.concatenate([mat.unpack() for mat in matrices], axis=1))
    else:
        return SplitMatrix(matrices)


def _merge_group(blocks, col_lists):
    """Fuse several same-typed blocks into one, re-sorted into global order.

    The fused block owns the union of the members' global columns; since each
    member's column list is ascending but the union interleaves, the stacked
    columns are permuted so the fused block's index array is ascending again.
    Column/term names ride along through the permutation.
    """
    stacked_cols = np.concatenate([np.asarray(c) for c in col_lists])
    order = np.argsort(stacked_cols)
    if isinstance(blocks[0], DenseMatrix):
        wide = jnp.concatenate([b.unpack() for b in blocks], axis=1)
        fused = DenseMatrix(wide[:, order])
    else:
        wide = sps.hstack([b.unpack() for b in blocks], format="csc")
        fused = SparseMatrix(wide[:, order])
    names = np.concatenate([np.asarray(b._colnames, dtype=object) for b in blocks])
    terms = np.concatenate([np.asarray(b._terms, dtype=object) for b in blocks])
    fused._colnames = names[order].tolist()
    fused._terms = terms[order].tolist()
    return fused, stacked_cols[order]


def _coalesce_blocks(blocks, col_lists):
    """Drop zero-width blocks; fuse all dense blocks into one, ditto sparse.

    Categorical blocks are never fused — each stands for a single model term
    and its kernels are per-block.  The fused block takes the list position of
    the group's first member.  (Same invariants as the reference's block
    combination step, ``tabmat/split_matrix.py:85-141``, derived independently.)
    """
    kept = [
        (b, c) for b, c in zip(blocks, col_lists, strict=True) if b.shape[1] > 0
    ]
    groups = {DenseMatrix: [], SparseMatrix: []}
    for pos, (b, _) in enumerate(kept):
        for klass, members in groups.items():
            if isinstance(b, klass):
                members.append(pos)
    fuse_at = {}  # first-member position -> fused (block, cols)
    absorbed = set()
    for members in groups.values():
        if len(members) > 1:
            fuse_at[members[0]] = _merge_group(
                [kept[p][0] for p in members], [kept[p][1] for p in members]
            )
            absorbed.update(members[1:])
    out_blocks, out_cols = [], []
    for pos, (b, c) in enumerate(kept):
        if pos in absorbed:
            continue
        b, c = fuse_at.get(pos, (b, c))
        out_blocks.append(b)
        out_cols.append(c)
    return out_blocks, out_cols


def _place_segments(segments, positions, total_len, xp):
    """Scatter-free assembly: place 1-d ``segments`` at global ``positions``.

    Builds ``concat(segments + [0])`` and gathers it through a
    host-precomputed index map (missing positions hit the trailing zero).
    """
    index_map = np.full(total_len, -1, dtype=np.int64)
    off = 0
    for seg, pos in zip(segments, positions):
        index_map[np.asarray(pos)] = off + np.arange(len(pos))
        off += len(pos)
    index_map[index_map < 0] = off  # point at the zero slot
    if xp is np:
        segs = [np.asarray(s) for s in segments]
        flat = np.concatenate(segs + [np.zeros((1,) + segs[0].shape[1:], segs[0].dtype)])
        return flat[index_map]
    segs = [jnp.asarray(s) for s in segments]
    flat = jnp.concatenate(
        segs + [jnp.zeros((1,) + tuple(segs[0].shape[1:]), segs[0].dtype)]
    )
    return jnp.take(flat, jnp.asarray(index_map), axis=0)


class SplitMatrix(MatrixBase):
    """Matrix with dense, sparse and categorical column blocks."""

    __array_priority__ = 13

    def __init__(
        self,
        matrices: Sequence[MatrixBase],
        indices: Optional[list[np.ndarray]] = None,
    ):
        blocks, default_cols = self._flatten_inputs(matrices)
        self._validate_blocks(blocks)
        self.dtype = blocks[0].dtype

        if indices is None:
            block_cols = default_cols
            n_col = int(sum(len(c) for c in block_cols))
        else:
            block_cols = [np.asarray(ix, dtype=np.int64) for ix in indices]
            n_col = self._validate_cols(blocks, block_cols)

        self.matrices, kept_cols = _coalesce_blocks(blocks, block_cols)
        self.indices = [np.asarray(c, dtype=np.int64) for c in kept_cols]
        self.shape = (blocks[0].shape[0], n_col)
        assert self.shape[1] > 0

    @staticmethod
    def _flatten_inputs(matrices):
        """Flatten any nested SplitMatrix inputs into leaf blocks.

        Returns the leaf blocks plus the default global-column assignment:
        each top-level entry claims the next contiguous span of columns, and a
        nested split's leaves keep their relative layout inside that span.
        """
        blocks: list[MatrixBase] = []
        default_cols: list[np.ndarray] = []
        cursor = 0
        for entry in matrices:
            if not isinstance(entry, MatrixBase):
                raise ValueError(
                    "Expected all elements of matrices to be subclasses of MatrixBase."
                )
            if isinstance(entry, SplitMatrix):
                for leaf, leaf_cols in zip(entry.matrices, entry.indices):
                    blocks.append(leaf)
                    default_cols.append(cursor + np.asarray(leaf_cols, np.int64))
                cursor += entry.shape[1]
            else:
                width = entry.shape[1] if entry.ndim > 1 else 1
                blocks.append(entry)
                default_cols.append(np.arange(cursor, cursor + width, dtype=np.int64))
                cursor += width
        return blocks, default_cols

    @staticmethod
    def _validate_blocks(blocks):
        """Shared-shape and dtype checks; promote 1-d blocks to columns."""
        n_row = blocks[0].shape[0]
        ref_dtype = blocks[0].dtype
        for i, blk in enumerate(blocks):
            if blk.dtype != ref_dtype:
                warnings.warn(
                    "Matrices do not all have the same dtype. Dtypes are "
                    f"{[elt.dtype for elt in blocks]}."
                )
            if blk.shape[0] != n_row:
                raise ValueError(
                    "All matrices should have the same first dimension, "
                    f"but the first matrix has first dimension {n_row} and "
                    f"matrix {i} has first dimension {blk.shape[0]}."
                )
            if blk.ndim == 1:
                blocks[i] = blk[:, np.newaxis]
            elif blk.ndim > 2:
                raise ValueError("All matrices should be at most two dimensional.")

    @staticmethod
    def _validate_cols(blocks, block_cols):
        """Check an explicit column assignment; returns the column count.

        The concatenated assignment must be a permutation of ``0..n_col-1``
        and each block's piece must be ascending (kernels and name plumbing
        rely on ascending per-block columns).
        """
        from .. import _native

        flat = np.concatenate(block_cols)
        n_col = len(flat)
        if not np.array_equal(np.sort(flat), np.arange(n_col, dtype=flat.dtype)):
            raise ValueError(
                "Indices should contain all integers from 0 to one less than "
                "the number of columns."
            )
        for i, cols in enumerate(block_cols):
            if not _native.is_sorted(cols):
                raise ValueError(
                    f"Each index block should be sorted, but indices[{i}] was "
                    "not sorted"
                )
        for i, (blk, cols) in enumerate(zip(blocks, block_cols)):
            if blk.shape[1] != len(cols):
                raise ValueError(
                    f"Length mismatch: block {i} has {blk.shape[1]} columns but "
                    f"its index array has shape {cols.shape}"
                )
        return n_col

    # -- restriction plumbing --------------------------------------------

    def _split_col_subsets(self, cols):
        """Map a global column active-set onto each block.

        Returns ``(subset_cols_indices, subset_cols, n_cols)`` satisfying
        ``self.indices[i][subset_cols[i]] == cols[subset_cols_indices[i]]``.
        Vectorized numpy replacement for the reference's Cython merge-walk
        (``tabmat/ext/split.pyx:157-209``).
        """
        if cols is None:
            return self.indices, [None] * len(self.indices), self.shape[1]

        cols = set_up_rows_or_cols(cols, self.shape[1])
        order = np.argsort(cols, kind="stable")
        sorted_cols = cols[order]

        subset_cols_indices = []
        subset_cols = []
        for idx in self.indices:
            pos = np.searchsorted(sorted_cols, idx)
            pos_clipped = np.minimum(pos, len(sorted_cols) - 1)
            found = sorted_cols[pos_clipped] == idx
            subset_cols.append(np.where(found)[0].astype(np.int64))
            subset_cols_indices.append(order[pos_clipped[found]].astype(np.int64))
        return subset_cols_indices, subset_cols, len(cols)

    # -- core ops -----------------------------------------------------------

    def _get_device_design(self):
        """Lazily build (and cache) the DeviceDesign twin of this matrix."""
        dd = getattr(self, "_device_design", None)
        if dd is None:
            from ..parallel.design import DeviceDesign

            dd = DeviceDesign.from_matrix(self)
            self._device_design = dd
        return dd

    def _device_sandwich_ok(self) -> bool:
        """True when the fused device-side sandwich assembly covers this mix.

        The DeviceDesign unit grid covers one dense block, one sparse
        block, and any number of categorical blocks whose pairwise plans
        are bounded (cat×cat and cat×sparse combined codes ≤ 2^24, sparse
        pair expansion within the SparseMatrix budgets).  This is a cheap
        static screen — the built design's ``supports_sandwich`` stays
        authoritative.
        """
        from ..parallel.design import DeviceDesign, SPARSE_CAT_MAX_SEGMENTS
        from .categorical import CategoricalMatrix
        from .sparse import (
            PAIR_SANDWICH_MAX_PAIRS,
            PAIR_SANDWICH_MAX_SEGMENTS,
            SparseMatrix,
        )

        if self.shape[1] > DeviceDesign.SANDWICH_MAX_COLS:
            return False
        cat_widths = []
        sparse_mats = []
        n_dense = 0
        for m in self.matrices:
            if isinstance(m, CategoricalMatrix):
                cat_widths.append(m.shape[1])
            elif isinstance(m, DenseMatrix):
                n_dense += 1
            elif isinstance(m, SparseMatrix):
                sparse_mats.append(m)
            else:
                return False
        if n_dense > 1 or len(sparse_mats) > 1:
            return False
        for m in sparse_mats:
            n, ks = m.shape
            counts = np.bincount(m._array.indices, minlength=n)
            if int((counts.astype(np.int64) ** 2).sum()) > PAIR_SANDWICH_MAX_PAIRS:
                return False
            if ks * ks > PAIR_SANDWICH_MAX_SEGMENTS:
                return False
            if any(w * ks > SPARSE_CAT_MAX_SEGMENTS for w in cat_widths):
                return False
        if not all(
            w1 * w2 <= (1 << 24)
            for a, w1 in enumerate(cat_widths)
            for w2 in cat_widths[a + 1 :]
        ):
            return False
        return self._get_device_design().supports_sandwich

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_device_design", None)
        return state

    def sandwich(
        self,
        d,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Block sandwich: per-block diagonal + pairwise cross terms.

        Host callers (numpy ``d``) get the reference-style host assembly
        (per-block diagonal + cross blocks into ``np.ix_`` views —
        ``tabmat/split_matrix.py:324-356``).  Device callers (jax ``d``)
        stay device-resident end to end: the whole blockwise product is one
        jitted XLA program over the cached DeviceDesign and the (k, k)
        result is returned WITHOUT a host download.
        """
        d_np = d if hasattr(d, "dtype") else np.asarray(d)
        check_sandwich_compatible(self, d_np)

        if is_jax_array(d_np) and self._device_sandwich_ok():
            w = d_np
            if rows is not None and not is_full_length(rows, self.shape[0]):
                # row restriction ≡ masking the weights (sandwich is a pure
                # row reduction); ship the mask as bytes, widen on device
                mask = np.zeros(self.shape[0], dtype=np.uint8)
                mask[np.asarray(rows)] = 1
                w = w * jnp.asarray(mask).astype(w.dtype)
            H = _device_design_sandwich(self._get_device_design(), w)
            if cols is not None and not is_identity_index(cols, self.shape[1]):
                c = jnp.asarray(np.asarray(cols, dtype=np.int32))
                H = jnp.take(jnp.take(H, c, axis=0), c, axis=1)
            return H

        # upload the weights ONCE; per-block ops then reuse the device copy
        # (host->device transfer is the dominant per-op cost on slow links)
        d_dev = d_np if is_jax_array(d_np) else jnp.asarray(d_np)

        subset_cols_indices, subset_cols, n_cols = self._split_col_subsets(cols)

        out = np.zeros((n_cols, n_cols))
        for i in range(len(self.indices)):
            idx_i = subset_cols_indices[i]
            mat_i = self.matrices[i]
            res = mat_i.sandwich(d_dev, rows, subset_cols[i])
            if isinstance(res, DiagonalResult):
                out[(idx_i, idx_i)] += np.asarray(res.diag)
            elif isinstance(res, sps.dia_matrix):
                out[(idx_i, idx_i)] += np.squeeze(res.data)
            else:
                out[np.ix_(idx_i, idx_i)] = np.asarray(res)

            for j in range(i + 1, len(self.indices)):
                idx_j = subset_cols_indices[j]
                mat_j = self.matrices[j]
                res = mat_i._cross_sandwich(
                    mat_j, d_dev, rows, subset_cols[i], subset_cols[j]
                )
                res = np.asarray(res)
                out[np.ix_(idx_i, idx_j)] = res
                out[np.ix_(idx_j, idx_i)] = res.T

        return out

    def matvec(self, v, cols: Optional[np.ndarray] = None, out=None) -> np.ndarray:
        """``X[:, cols] @ v[cols]`` — per-block matvecs accumulated."""
        assert not isinstance(v, sps.spmatrix)
        v_in = v
        v = v if is_jax_array(v) else np.asarray(v)
        check_matvec_dimensions(self, v, transpose=False)
        check_matvec_out_shape(self, out)

        if (
            is_jax_array(v_in)
            and v.ndim == 1
            and out is None
            and np.dtype(v.dtype) == np.dtype(self.dtype)
        ):
            # device caller: one jitted program over the cached design
            # (column restriction ≡ masking v — matvec sums over columns)
            ve = v
            if cols is not None and not is_identity_index(cols, self.shape[1]):
                cmask = np.zeros(self.shape[1], dtype=np.uint8)
                cmask[np.asarray(cols)] = 1
                ve = ve * jnp.asarray(cmask).astype(ve.dtype)
            return _device_design_matvec(self._get_device_design(), ve)

        _, subset_cols, n_cols = self._split_col_subsets(cols)

        out_shape = [self.shape[0]] + ([] if v.ndim == 1 else list(v.shape[1:]))
        out_dtype = np.result_type(self.dtype, v.dtype)
        if out is None:
            if is_jax_array(v_in):
                out = jnp.zeros(out_shape, out_dtype)
            else:
                out = np.zeros(out_shape, out_dtype)
        elif isinstance(out, np.ndarray) and out.dtype != out_dtype:
            raise ValueError(
                f"out array is required to have dtype {out_dtype} but has "
                f"dtype {out.dtype}"
            )

        for sub_cols, idx, mat in zip(subset_cols, self.indices, self.matrices):
            in_vec = v[idx, ...] if isinstance(v, np.ndarray) else jnp.take(v, jnp.asarray(idx), axis=0)
            out = mat.matvec(in_vec, sub_cols, out=out)
        return out

    def transpose_matvec(
        self,
        v,
        rows: Optional[np.ndarray] = None,
        cols: Optional[np.ndarray] = None,
        out=None,
    ) -> np.ndarray:
        """``X[rows, cols].T @ v[rows]`` — per-block results placed by index."""
        v_in = v
        v = v if is_jax_array(v) else np.asarray(v)
        check_matvec_dimensions(self, v, transpose=True)
        check_transpose_matvec_out_shape(self, out)

        if (
            is_jax_array(v_in)
            and v.ndim == 1
            and out is None
            and np.dtype(v.dtype) == np.dtype(self.dtype)
        ):
            # device caller: fused blockwise tmv (row restriction ≡ byte
            # mask on the weights; column restriction gathers the output)
            ve = v
            if rows is not None and not is_full_length(rows, self.shape[0]):
                rmask = np.zeros(self.shape[0], dtype=np.uint8)
                rmask[np.asarray(rows)] = 1
                ve = ve * jnp.asarray(rmask).astype(ve.dtype)
            res_full = _device_design_tmv(self._get_device_design(), ve)
            if cols is not None and not is_identity_index(cols, self.shape[1]):
                c = jnp.asarray(np.asarray(cols, dtype=np.int32))
                return jnp.take(res_full, c)
            return res_full

        subset_cols_indices, subset_cols, n_cols = self._split_col_subsets(cols)
        out_dtype = np.result_type(self.dtype, v.dtype)
        use_np = not is_jax_array(v_in)
        # single upload shared by every block op
        v_dev = v if is_jax_array(v) else jnp.asarray(v)

        segments = []
        for idx, sub_cols, mat in zip(subset_cols_indices, subset_cols, self.matrices):
            segments.append(mat.transpose_matvec(v_dev, rows=rows, cols=sub_cols))

        if use_np:
            out_is_none = out is None
            if out_is_none:
                out = np.zeros([n_cols] + list(v.shape[1:]), out_dtype)
            elif out.dtype != out_dtype:
                raise ValueError(
                    f"out array is required to have dtype {out_dtype} but has "
                    f"dtype {out.dtype}"
                )
            cols_arr = None if cols is None else np.asarray(cols, dtype=np.int64)
            for idx, seg in zip(subset_cols_indices, segments):
                if out_is_none or cols_arr is None:
                    out[idx, ...] += np.asarray(seg, dtype=out.dtype)
                else:
                    out[cols_arr[idx], ...] += np.asarray(seg, dtype=out.dtype)
            return out

        # jax flavor: scatter-free placement
        if out is None:
            placed = _place_segments(segments, subset_cols_indices, n_cols, jnp)
            return placed.astype(out_dtype)
        cols_arr = None if cols is None else np.asarray(cols, dtype=np.int64)
        if cols_arr is None:
            positions = subset_cols_indices
            total = self.shape[1]
        else:
            positions = [cols_arr[idx] for idx in subset_cols_indices]
            total = out.shape[0]
        placed = _place_segments(segments, positions, total, jnp)
        return out + placed.astype(out.dtype)

    # -- statistics ---------------------------------------------------------

    def _get_col_means(self, weights) -> np.ndarray:
        """Weighted column means, per block."""
        col_means = np.empty(self.shape[1], dtype=self.dtype)
        for idx, mat in zip(self.indices, self.matrices):
            col_means[idx] = np.asarray(mat._get_col_means(weights))
        return col_means

    def _get_col_stds(self, weights, col_means) -> np.ndarray:
        """Weighted column stds, per block."""
        col_stds = np.empty(self.shape[1], dtype=self.dtype)
        for idx, mat in zip(self.indices, self.matrices):
            col_stds[idx] = np.asarray(mat._get_col_stds(weights, col_means[idx]))
        return col_stds

    # -- conversions ----------------------------------------------------------

    def astype(self, dtype, order="K", casting="unsafe", copy=True):
        """Cast all blocks."""
        if copy:
            new_matrices = [
                mat.astype(dtype=dtype, order=order, casting=casting, copy=True)
                for mat in self.matrices
            ]
            return SplitMatrix(new_matrices, self.indices)
        for i in range(len(self.matrices)):
            self.matrices[i] = self.matrices[i].astype(
                dtype=dtype, order=order, casting=casting, copy=False
            )
        return SplitMatrix(self.matrices, self.indices)

    def toarray(self) -> np.ndarray:
        """Densify to host numpy."""
        out = np.empty(self.shape)
        for mat, idx in zip(self.matrices, self.indices):
            out[:, idx] = mat.toarray()
        return out

    def getcol(self, i: int):
        """Column ``i`` (wrap-around) from whichever block owns it."""
        i %= self.shape[1]
        for mat, idx in zip(self.matrices, self.indices):
            if i in idx:
                loc = np.where(idx == i)[0][0]
                return mat.getcol(loc)
        raise RuntimeError(f"Column {i} was not found.")

    def __getitem__(self, key):
        if isinstance(key, tuple):
            row, col = key
        else:
            row = key
            col = slice(None, None, None)

        if not (isinstance(col, slice) and col == slice(None, None, None)):
            raise NotImplementedError(
                f"Only row indexing is supported. Index passed was {key}."
            )
        if isinstance(row, int):
            row = [row]
        return SplitMatrix([mat[row, :] for mat in self.matrices], self.indices)

    def multiply(self, other):
        """Row-wise scaling of every block."""
        return SplitMatrix(
            [mat.multiply(other) for mat in self.matrices], indices=self.indices
        )

    def __repr__(self):
        out = "SplitMatrix:"
        for i, mat in enumerate(self.matrices):
            out += (
                f"\n\nComponent {i} with type {mat.__class__.__name__}\n" + repr(mat)
            )
        return out

    # -- names -----------------------------------------------------------------

    def get_names(
        self,
        type: str = "column",
        missing_prefix: Optional[str] = None,
        indices: Optional[list[int]] = None,
    ) -> list[Optional[str]]:
        """Gather names from all blocks in global column order."""
        names: np.ndarray = np.empty(self.shape[1], dtype=object)
        for idx, mat in zip(self.indices, self.matrices):
            names[idx] = mat.get_names(type, missing_prefix, idx)
        return names.tolist()

    def set_names(self, names, type: str = "column"):
        """Distribute names to the owning blocks."""
        names_array = np.array(names, dtype=object)
        if len(names) != self.shape[1]:
            raise ValueError(f"Length of names must be {self.shape[1]}")
        for idx, mat in zip(self.indices, self.matrices):
            mat.set_names(names_array[idx].tolist(), type)
