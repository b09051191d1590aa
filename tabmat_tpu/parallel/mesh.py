"""Device-mesh helpers for multi-chip tabmat-tpu.

The reference has no distributed machinery (single-node OpenMP; SURVEY §2).
Scale-out is simple because every core op is a **linear reduction over
rows**: shard the row dimension across devices ('dp' axis) and every
sandwich / transpose-matvec becomes per-shard partial results + one
all-reduce of a small (k,)- or (k,k)-shaped output.  Dense column blocks
can additionally shard their column axis ('mp') for very wide designs.
"""

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    mp: int = 1,
    axis_names: Sequence[str] = ("dp", "mp"),
) -> Mesh:
    """Build a (dp × mp) mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % mp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by mp={mp}")
    dp = n_devices // mp
    dev_array = np.asarray(devices[:n_devices]).reshape(dp, mp)
    return Mesh(dev_array, axis_names=tuple(axis_names))


def shard_rows(x, mesh: Mesh, extra_axes: int = 0):
    """Place an array with its leading (row) axis sharded over 'dp'."""
    spec = P("dp", *([None] * extra_axes))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(x, mesh: Mesh):
    """Place an array fully replicated on the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_rows_cols(x, mesh: Mesh):
    """Shard rows over 'dp' and columns over 'mp' (dense design blocks)."""
    return jax.device_put(x, NamedSharding(mesh, P("dp", "mp")))
