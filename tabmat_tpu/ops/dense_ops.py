"""Dense kernels: sandwich, matvec, transpose-matvec, weighted column stats.

Plain-XLA replacement for the reference's BLIS-style C++ sandwich and
row/col-restricted matvec kernels (``tabmat/ext/dense.pyx:19-122``,
``ext/dense_helpers-tmpl.cpp:41-311``).  Design differences, deliberately:

- No panel packing / register blocking: XLA hands the contractions to the
  GPU's BLAS and fuses the ``diag(d)`` scaling.  Every contraction goes
  through :func:`matmul`, which pins full precision so float32 operands
  never run in TF32.
- Row restriction = multiplying a 0/1 mask into ``d``/``vec`` — exact,
  because every op is a linear reduction over rows.  Static shapes, no
  copies of ``X``.
- Column restriction = a gather along the small column axis, optionally
  padded to power-of-two buckets so active-set shrinkage (GLM coordinate
  descent) triggers O(log k) compiles instead of O(k).
"""

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a @ b`` at ``Precision.HIGHEST``.

    XLA may run a float32 product in TF32 (10-bit mantissa) unless the
    precision is pinned; float64 products are unaffected.  Every
    contraction of the library's compute path goes through here.
    """
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@jax.jit
def sandwich(X: jax.Array, d: jax.Array) -> jax.Array:
    """Unrestricted sandwich ``X.T @ diag(d) @ X`` → (k, k)."""
    return matmul((X * d[:, None]).T, X)


@jax.jit
def apply_mask(v: jax.Array, mask: jax.Array) -> jax.Array:
    """Multiplicative 0/1 row/col mask."""
    return v * mask


@jax.jit
def matvec(X: jax.Array, v: jax.Array) -> jax.Array:
    """``X @ v`` (v may be 1-d or 2-d)."""
    return matmul(X, v)


@jax.jit
def transpose_matvec(X: jax.Array, v: jax.Array) -> jax.Array:
    """``X.T @ v`` (v may be 1-d or 2-d)."""
    return matmul(X.T, v)


@jax.jit
def gather_cols(X: jax.Array, cols: jax.Array) -> jax.Array:
    """``X[:, cols]`` on device."""
    return jnp.take(X, cols, axis=1)


@jax.jit
def scale_cols(X: jax.Array, colmask: jax.Array) -> jax.Array:
    """Zero out unselected columns."""
    return X * colmask[None, :]


@jax.jit
def transpose_square_dot_weights(
    X: jax.Array, weights: jax.Array, shift: jax.Array
) -> jax.Array:
    """``sum_i weights[i] * (X[i, j] - shift[j])**2`` per column j.

    The shifted form is the numerically robust variance used by the
    reference for dense column stds (``tabmat/ext/dense.pyx:103-122``).
    An explicit axis-0 sum is used instead of a dot-style contraction.
    """
    centered = X - shift[None, :]
    return jnp.sum(weights[:, None] * centered * centered, axis=0)


# ----------------------------------------------------------------------
# column-restriction helpers (host side)
# ----------------------------------------------------------------------

_BUCKET_MIN = 8


def bucket_size(k: int) -> int:
    """Round up to the next power of two (≥ 8) to bound compile count."""
    b = _BUCKET_MIN
    while b < k:
        b <<= 1
    return b


def pad_cols(cols: np.ndarray, bucket: bool) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad a column index array to its bucket size.

    Returns (padded_cols, colmask, true_len): padded entries point at column
    0 and are zeroed by ``colmask``, so downstream reductions stay exact;
    callers slice the first ``true_len`` entries of any result axis.
    """
    k = len(cols)
    if not bucket:
        return cols, np.ones(k, dtype=np.float64), k
    b = bucket_size(k)
    padded = np.zeros(b, dtype=cols.dtype)
    padded[:k] = cols
    mask = np.zeros(b, dtype=np.float64)
    mask[:k] = 1
    return padded, mask, k


def sandwich_restricted(
    X: jax.Array,
    d: jax.Array,
    row_mask: Optional[jax.Array],
    cols: Optional[np.ndarray],
    bucket: bool = True,
) -> tuple[jax.Array, int]:
    """Sandwich with active-set restriction.

    Returns ``(S, k)`` where ``S`` is (B, B) with B ≥ k = number of selected
    columns; the caller slices ``S[:k, :k]``.
    """
    dm = apply_mask(d, row_mask) if row_mask is not None else d
    if cols is None:
        S = sandwich(X, dm)
        return S, S.shape[0]
    padded, colmask, k = pad_cols(np.asarray(cols), bucket)
    Xs = gather_cols(X, jnp.asarray(padded))
    Xs = scale_cols(Xs, jnp.asarray(colmask, dtype=X.dtype))
    return sandwich(Xs, dm), k
