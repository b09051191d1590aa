"""Categorical (one-hot) kernels: pure gather / segment-sum formulations.

Device replacement for the reference's index-vector Cython kernels
(``tabmat/ext/categorical.pyx:128-315``).  A categorical matrix is just an
int32 code vector; with ``eff = codes - drop_first`` (so missing/-1 and the
dropped level both land below zero):

- ``matvec``:            ``out[i] = v[eff[i]]`` (gather; invalid → 0)
- ``transpose_matvec``:  ``out[c] = Σ_{i: eff[i]=c} v[i]`` (SegmentPlan)
- ``sandwich``:          diagonal ``Σ_{i: eff[i]=c} d[i]`` (SegmentPlan)

No atomics, no scatter: reductions ride the argsort/cumsum SegmentPlan
(see ``tabmat_tpu.ops.segments``), whose argsort is computed once per
matrix and cached.
"""

import jax
import jax.numpy as jnp


@jax.jit
def take_matvec(eff_codes: jax.Array, v: jax.Array) -> jax.Array:
    """``out[i] = v[eff_codes[i]]`` with negative codes contributing zero."""
    if v.shape[0] == 0:
        # zero-column matrix (drop_first with a single level): every code
        # is masked, so the matvec is identically zero
        return jnp.zeros(eff_codes.shape, dtype=v.dtype)
    valid = eff_codes >= 0
    gathered = jnp.take(v, jnp.clip(eff_codes, 0, v.shape[0] - 1))
    return jnp.where(valid, gathered, jnp.zeros((), dtype=gathered.dtype))


@jax.jit
def masked_values(v: jax.Array, mask: jax.Array) -> jax.Array:
    """Apply a 0/1 row mask to the reduced operand."""
    return v * mask
