"""Host/device array plumbing.

tabmat-tpu keeps a dual-calling-convention contract:

- numpy in → numpy out, and a numpy ``out=`` buffer is mutated in place
  (exact parity with the reference's accumulation semantics,
  ``tabmat/matrix_base.py:14-62``);
- jax in → jax out, and ``out=`` is treated functionally: the returned array
  is ``out + result`` and the caller rebinds (XLA may donate/alias buffers).

This keeps the library drop-in usable for CPU/numpy GLM solvers while
remaining composable inside jitted device programs.
"""

from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

Array = Union[np.ndarray, jax.Array]


def is_jax_array(x) -> bool:
    """True for a jax.Array (including tracers)."""
    return isinstance(x, (jax.Array, jax.core.Tracer))


def to_device(x, dtype=None) -> jax.Array:
    """Upload to the default device (no-op for jax arrays of right dtype)."""
    if dtype is not None:
        return jnp.asarray(x, dtype=dtype)
    return jnp.asarray(x)


def to_numpy(x) -> np.ndarray:
    """Bring an array to the host as numpy."""
    if isinstance(x, np.ndarray):
        return x
    return np.asarray(x)


def result_like(template, result: jax.Array):
    """Convert a device result to match the caller's array flavor.

    If the caller passed numpy (or a list), return a writable numpy array
    (parity: the reference hands back freshly-allocated numpy buffers); if
    they passed a jax array, return the device array untouched.
    """
    if is_jax_array(template):
        return result
    out = np.asarray(result)
    if not out.flags.writeable:
        out = out.copy()
    return out


def add_into_out(out: Optional[Array], result: jax.Array):
    """Apply tabmat's ``out=`` accumulation contract.

    - ``out is None`` → return ``result`` (flavor follows the result).
    - numpy ``out``   → ``out += result`` in place, return ``out``.
    - jax ``out``     → return ``out + result`` (functional update).
    """
    if out is None:
        return result
    if isinstance(out, np.ndarray):
        out += np.asarray(result, dtype=out.dtype)
        return out
    return out + result.astype(out.dtype)


def rows_to_mask(rows: Optional[np.ndarray], n_rows: int, dtype) -> Optional[np.ndarray]:
    """Turn a row active-set into a 0/1 multiplicative mask (host-side).

    Row restriction of any of the three core ops is exactly equivalent to
    zeroing the complementary rows of the reduced operand (``d`` or ``vec``),
    because each op is a linear reduction over rows.  Returns None when the
    restriction covers all rows (fast path: no mask multiply).

    Built on the host with numpy: the row indices are host data, and the
    mask ships to the device with the op's other operands.
    """
    if rows is None or len(rows) == n_rows:
        return None
    mask = np.zeros(n_rows, dtype=dtype)
    mask[rows] = 1
    return mask


def cols_to_mask(cols: Optional[np.ndarray], n_cols: int, dtype) -> Optional[np.ndarray]:
    """Turn a column active-set into a 0/1 mask over columns (host-side)."""
    if cols is None or len(cols) == n_cols:
        return None
    mask = np.zeros(n_cols, dtype=dtype)
    mask[cols] = 1
    return mask
