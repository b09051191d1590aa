"""Scatter-free segment reduction — the core primitive of tabmat-tpu.

The reference implements categorical/sparse reductions with scatter-adds
protected by OpenMP atomics or per-thread buffers
(``tabmat/ext/cat_split_helpers-tmpl.cpp:4-94``).  Here every
"out[key[i]] += val[i]" runs through a **SegmentPlan** instead, which is
deterministic and needs no atomics:

1. once per key array (= per matrix, since keys are structural):
   ``perm = argsort(keys)``, ``bounds = searchsorted(sorted_keys, 0..K)``;
2. per operation: gather values through ``perm``, inclusive ``cumsum``,
   and difference the cumsum at ``bounds`` — a pure gather/scan pipeline.

Cost per op: one (n,)-gather + one (n,)-cumsum + one (K+1,)-gather.  The
argsort happens once at construction and is cached on the owning matrix.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class SegmentPlan:
    """Precomputed reduction plan for a fixed integer key array.

    Attributes
    ----------
    perm: (n,) int32 device array — stable argsort of the keys.
    bounds: (num_segments + 1,) int32 device array — segment boundaries in
        the sorted order; segment ``s`` occupies ``perm[bounds[s]:bounds[s+1]]``.
    num_segments: static int.
    """

    perm: jax.Array
    bounds: jax.Array
    num_segments: int

    def sum(self, values: jax.Array) -> jax.Array:
        """Segment-sum ``values`` by the plan's keys → (num_segments,)."""
        return _segment_sum(self.perm, self.bounds, values)

    def sum2d(self, values: jax.Array) -> jax.Array:
        """Row-wise segment-sum of a (n, m) matrix → (num_segments, m)."""
        return _segment_sum_2d(self.perm, self.bounds, values)


def build_plan(keys: np.ndarray, num_segments: int) -> SegmentPlan:
    """Build a SegmentPlan on the host (done once per matrix).

    Host construction is deliberate: it runs while the device is busy and
    avoids paying a device sort compile for every new (n,) shape.  Keys are
    bounded ints, so the native O(n + K) counting sort is used when the
    helper library is available (``tabmat_tpu._native``), with a numpy
    argsort fallback.  Out-of-range keys (e.g. -1 for missing categories)
    sort to the front and fall outside every bound pair.
    """
    keys = np.asarray(keys)
    if keys.dtype != np.int32 and num_segments < 2**31 and (
        len(keys) == 0 or keys.max(initial=0) < 2**31
    ):
        keys32 = keys.astype(np.int32, copy=False)
    else:
        keys32 = keys

    # counting sort allocates O(num_segments) — cap to keep memory bounded
    if keys32.dtype == np.int32 and num_segments <= (1 << 24):
        from .. import _native

        perm, bounds = _native.counting_argsort(keys32, num_segments)
    else:
        perm = np.argsort(keys, kind="stable").astype(np.int64)
        sorted_keys = keys[perm]
        bounds = np.searchsorted(
            sorted_keys, np.arange(num_segments + 1, dtype=keys.dtype)
        ).astype(np.int64)
    return SegmentPlan(
        perm=jnp.asarray(perm),
        bounds=jnp.asarray(bounds),
        num_segments=num_segments,
    )


@jax.jit
def _segment_sum(perm: jax.Array, bounds: jax.Array, values: jax.Array) -> jax.Array:
    gathered = jnp.take(values, perm)
    csum = jnp.cumsum(gathered)
    padded = jnp.concatenate([jnp.zeros((1,), dtype=csum.dtype), csum])
    return jnp.take(padded, bounds[1:]) - jnp.take(padded, bounds[:-1])


@jax.jit
def _segment_sum_2d(perm: jax.Array, bounds: jax.Array, values: jax.Array) -> jax.Array:
    gathered = jnp.take(values, perm, axis=0)
    csum = jnp.cumsum(gathered, axis=0)
    padded = jnp.concatenate(
        [jnp.zeros((1, values.shape[1]), dtype=csum.dtype), csum], axis=0
    )
    return jnp.take(padded, bounds[1:], axis=0) - jnp.take(padded, bounds[:-1], axis=0)
