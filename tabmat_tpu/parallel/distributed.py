"""Distributed mixed-design GLM training step (dp × mp sharding).

One jittable function covering the full tabmat workload — a SplitMatrix-like
design with dense + sparse(CSR/CSC) + categorical blocks — written directly
against the scatter-free device kernels so XLA/GSPMD can partition it:

- rows (data axis) shard over 'dp': sandwich/matvec partials all-reduce;
- dense design columns may shard over 'mp';
- categorical reductions ride the SegmentPlan gather/cumsum (the permutation
  gather becomes an all-to-all; the cumsum a cross-shard scan — both XLA
  collectives, no scatter).

Used by ``chip_smoke.py --four-cards`` and the multi-device tests.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dense_ops


class MixedDesign(NamedTuple):
    """Device arrays for a dense + sparse + categorical design.

    Column layout (static): [dense | sparse | categorical].
    """

    dense: jax.Array  # (n, kd)
    sp_csr_data: jax.Array  # (nnz,)
    sp_csr_cols: jax.Array  # (nnz,) int
    sp_csr_bounds: jax.Array  # (n+1,) int
    sp_csc_data: jax.Array  # (nnz,)
    sp_csc_rows: jax.Array  # (nnz,) int
    sp_csc_bounds: jax.Array  # (ks+1,) int
    cat_codes: jax.Array  # (n,) int
    cat_perm: jax.Array  # (n,) int — argsort of codes
    cat_bounds: jax.Array  # (kc+1,) int


def _bounded_sum(values, bounds):
    csum = jnp.cumsum(values)
    padded = jnp.concatenate([jnp.zeros((1,), dtype=csum.dtype), csum])
    return jnp.take(padded, bounds[1:]) - jnp.take(padded, bounds[:-1])


def design_matvec(dz: MixedDesign, v: jax.Array) -> jax.Array:
    """``X @ v`` for the mixed design (v in global column layout)."""
    kd = dz.dense.shape[1]
    ks = dz.sp_csc_bounds.shape[0] - 1
    vd, vs, vc = v[:kd], v[kd : kd + ks], v[kd + ks :]
    out = dense_ops.matmul(dz.dense, vd)
    out = out + _bounded_sum(
        dz.sp_csr_data * jnp.take(vs, dz.sp_csr_cols), dz.sp_csr_bounds
    )
    out = out + jnp.take(vc, dz.cat_codes)
    return out


def design_transpose_matvec(dz: MixedDesign, r: jax.Array) -> jax.Array:
    """``Xᵀ @ r`` for the mixed design → global column layout."""
    gd = dense_ops.matmul(dz.dense.T, r)
    gs = _bounded_sum(
        dz.sp_csc_data * jnp.take(r, dz.sp_csc_rows), dz.sp_csc_bounds
    )
    gathered = jnp.take(r, dz.cat_perm)
    gc = _bounded_sum(gathered, dz.cat_bounds)
    return jnp.concatenate([gd, gs, gc])


@partial(jax.jit, static_argnames=("family", "n_cg"))
def mixed_irls_step(
    dz: MixedDesign,
    y: jax.Array,
    sample_weight: jax.Array,
    beta: jax.Array,
    family: str = "poisson",
    n_cg: int = 8,
) -> jax.Array:
    """One full GLM training step over the mixed design (jittable/shardable)."""
    from ..glm import _cg_solve, _family_terms

    eta = design_matvec(dz, beta)
    mu, w_irls, resid = _family_terms(family, eta, y)
    w = sample_weight * w_irls
    grad = design_transpose_matvec(dz, sample_weight * resid)

    def hvp(v):
        return design_transpose_matvec(dz, w * design_matvec(dz, v)) + 1e-8 * v

    delta = _cg_solve(hvp, grad, n_cg)
    return beta + delta


def build_mixed_design(n: int, kd: int, ks: int, kc: int, seed: int = 0, density: float = 0.1):
    """Host-side construction of a random MixedDesign (numpy; upload via jnp)."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, kd))

    from scipy import sparse as sps

    sp = sps.random(n, ks, density=density, random_state=seed, format="csr")
    csc = sp.tocsc()

    codes = rng.integers(0, kc, n).astype(np.int32)
    perm = np.argsort(codes, kind="stable").astype(np.int32)
    bounds = np.searchsorted(codes[perm], np.arange(kc + 1)).astype(np.int32)

    return MixedDesign(
        dense=jnp.asarray(dense),
        sp_csr_data=jnp.asarray(sp.data),
        sp_csr_cols=jnp.asarray(sp.indices.astype(np.int32)),
        sp_csr_bounds=jnp.asarray(sp.indptr.astype(np.int32)),
        sp_csc_data=jnp.asarray(csc.data),
        sp_csc_rows=jnp.asarray(csc.indices.astype(np.int32)),
        sp_csc_bounds=jnp.asarray(csc.indptr.astype(np.int32)),
        cat_codes=jnp.asarray(codes),
        cat_perm=jnp.asarray(perm),
        cat_bounds=jnp.asarray(bounds),
    )
