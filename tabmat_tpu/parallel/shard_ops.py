"""Explicit shard_map kernels for row-sharded tabmat ops.

GSPMD auto-partitioning handles the core ops already (see
``tests/test_multichip.py``); this module provides the *explicit* SPMD
formulation — per-shard partials + one ``psum`` across the devices — which
makes the communication pattern auditable: a sandwich is a row reduction,
so the only collective is a (k, k)-sized psum per op.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..ops import dense_ops


def sharded_sandwich(X: jax.Array, d: jax.Array, mesh: Mesh) -> jax.Array:
    """``X.T @ diag(d) @ X`` with X, d sharded over mesh axis 'dp'.

    Each shard computes its local sandwich and the (k, k) partials are
    psum'd across the devices.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp")),
        out_specs=P(),
    )
    def _kernel(X_local, d_local):
        local = dense_ops.sandwich(X_local, d_local)
        return jax.lax.psum(local, axis_name="dp")

    return _kernel(X, d)


def sharded_transpose_matvec(X: jax.Array, v: jax.Array, mesh: Mesh) -> jax.Array:
    """``X.T @ v`` with row-sharded operands; one (k,)-psum."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp")),
        out_specs=P(),
    )
    def _kernel(X_local, v_local):
        return jax.lax.psum(
            dense_ops.transpose_matvec(X_local, v_local), axis_name="dp"
        )

    return _kernel(X, v)


def sharded_segment_sum(
    values: jax.Array, codes: jax.Array, num_segments: int, mesh: Mesh
) -> jax.Array:
    """Categorical reduction with row-sharded values/codes.

    Each shard sorts its local rows and cumsum-reduces them (a one-hot
    comparison matmul would be O(K·n)), then the partials psum across the
    devices.  The shard-local argsort happens inside the jitted kernel.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("dp"), P("dp")),
        out_specs=P(),
    )
    def _kernel(v_local, c_local):
        order = jnp.argsort(c_local)
        sorted_c = c_local[order]
        csum = jnp.cumsum(v_local[order])
        padded = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])
        bounds = jnp.searchsorted(
            sorted_c, jnp.arange(num_segments + 1, dtype=c_local.dtype)
        )
        local = jnp.take(padded, bounds[1:]) - jnp.take(padded, bounds[:-1])
        return jax.lax.psum(local, axis_name="dp")

    return _kernel(values, codes)


def place_row_sharded(mesh: Mesh, *arrays):
    """Device-put arrays with their leading axis sharded over 'dp'."""
    out = []
    for a in arrays:
        spec = P("dp", *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return out if len(out) > 1 else out[0]
