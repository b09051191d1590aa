"""Sparse (CSR/CSC) kernels: boundary-segmented cumsum reductions.

Device replacement for the reference's Cython CSC/CSR walkers
(``tabmat/ext/sparse.pyx:17-283``).  CSR and CSC orderings are themselves
sorted segment layouts, so every sparse reduction becomes:

    gather operand → elementwise multiply → cumsum over nnz → diff at indptr

with zero scatters and zero per-call sorting (the structure arrays are
uploaded once per matrix).  matvec walks CSR (segments = rows), transpose-
matvec and column statistics walk CSC (segments = columns).

The sparse×sparse sandwich uses a within-row pair expansion or a
densified device mirror, and falls back to host scipy for very wide
matrices; see ``SparseMatrix.sandwich`` for the policy.
"""

import jax
import jax.numpy as jnp


@jax.jit
def bounded_segment_sum(values: jax.Array, bounds: jax.Array) -> jax.Array:
    """Sum ``values`` within consecutive segments delimited by ``bounds``.

    ``bounds`` has length (num_segments + 1); segment s is
    ``values[bounds[s]:bounds[s+1]]``.  Pure cumsum+gather (no scatter).
    """
    csum = jnp.cumsum(values)
    padded = jnp.concatenate([jnp.zeros((1,), dtype=csum.dtype), csum])
    return jnp.take(padded, bounds[1:]) - jnp.take(padded, bounds[:-1])


@jax.jit
def bounded_segment_sum_2d(values: jax.Array, bounds: jax.Array) -> jax.Array:
    """Row-segment sum of an (nnz, p) matrix → (num_segments, p)."""
    csum = jnp.cumsum(values, axis=0)
    padded = jnp.concatenate(
        [jnp.zeros((1, values.shape[1]), dtype=csum.dtype), csum], axis=0
    )
    return jnp.take(padded, bounds[1:], axis=0) - jnp.take(padded, bounds[:-1], axis=0)


@jax.jit
def csr_matvec(
    data: jax.Array, col_idx: jax.Array, row_bounds: jax.Array, v: jax.Array
) -> jax.Array:
    """``out[r] = Σ_{nnz in row r} data * v[col]`` (CSR walk)."""
    t = data * jnp.take(v, col_idx)
    return bounded_segment_sum(t, row_bounds)


@jax.jit
def csc_rmatvec(
    data: jax.Array, row_idx: jax.Array, col_bounds: jax.Array, v: jax.Array
) -> jax.Array:
    """``out[c] = Σ_{nnz in col c} data * v[row]`` (CSC walk)."""
    t = data * jnp.take(v, row_idx)
    return bounded_segment_sum(t, col_bounds)


@jax.jit
def csc_rmatmat(
    data: jax.Array, row_idx: jax.Array, col_bounds: jax.Array, V: jax.Array
) -> jax.Array:
    """``out[c, :] = Σ_{nnz in col c} data * V[row, :]`` — X.T @ V for 2-d V."""
    t = data[:, None] * jnp.take(V, row_idx, axis=0)
    return bounded_segment_sum_2d(t, col_bounds)


@jax.jit
def csr_matmat(
    data: jax.Array, col_idx: jax.Array, row_bounds: jax.Array, V: jax.Array
) -> jax.Array:
    """``out[r, :] = Σ_{nnz in row r} data * V[col, :]`` — X @ V for 2-d V."""
    t = data[:, None] * jnp.take(V, col_idx, axis=0)
    return bounded_segment_sum_2d(t, row_bounds)


@jax.jit
def csc_square_dot_weights(
    data: jax.Array, row_idx: jax.Array, col_bounds: jax.Array, weights: jax.Array
) -> jax.Array:
    """``out[c] = Σ_{nnz in col c} data² * weights[row]`` (column E[X²])."""
    t = data * data * jnp.take(weights, row_idx)
    return bounded_segment_sum(t, col_bounds)


@jax.jit
def csc_cross_dense(
    data: jax.Array,
    row_idx: jax.Array,
    col_bounds: jax.Array,
    d: jax.Array,
    B: jax.Array,
) -> jax.Array:
    """Cross-sandwich ``X.T @ diag(d) @ B`` for sparse X (CSC) and dense B.

    ``out[c, j] = Σ_{nnz (r,c)} data · d[r] · B[r, j]`` — gathers of d and
    the dense rows, then a column-bounded segment sum.  Replaces the
    reference's blocked ``csr_dense_sandwich`` (``sparse_helpers-tmpl.cpp:23-146``).
    """
    t = (data * jnp.take(d, row_idx))[:, None] * jnp.take(B, row_idx, axis=0)
    return bounded_segment_sum_2d(t, col_bounds)
