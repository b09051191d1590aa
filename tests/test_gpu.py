"""Checks that only the card can make.

Run them on the GPU with ``python -m pytest -m gpu tests/test_gpu.py``.

On the CPU they skip (the ``gpu_device`` fixture decides, per test).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tabmat_tpu as tm
from tabmat_tpu.parallel.design import DeviceDesign

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("op", ["sandwich", "matvec", "transpose_matvec"])
def test_f32_ops_never_run_in_tf32(gpu_device, op):
    """1 + 2**-12 is exact in f32 and rounds to 1 in TF32's 10-bit mantissa."""
    x = 1.0 + 2.0**-12
    m = tm.DenseMatrix(np.full((256, 8), x, np.float32))
    ones_r, ones_c = jnp.ones(256, jnp.float32), jnp.ones(8, jnp.float32)
    got, want = {
        "sandwich": (m.sandwich(ones_r), 256 * x * x),
        "matvec": (m.matvec(ones_c), 8 * x),
        "transpose_matvec": (m.transpose_matvec(ones_r), 256 * x),
    }[op]
    assert next(iter(got.devices())) == gpu_device
    assert np.abs(np.asarray(got, np.float64) / want - 1).max() < 2.0**-14


def test_f32_design_sandwich_never_runs_in_tf32(gpu_device):
    x = 1.0 + 2.0**-12
    design = DeviceDesign.from_matrix(tm.DenseMatrix(np.full((256, 8), x)))
    d32 = design.astype_float(jnp.float32)
    H = jax.jit(lambda dd, w: dd.sandwich(w))(d32, jnp.ones(256, jnp.float32))
    assert np.abs(np.asarray(H, np.float64) / (256 * x * x) - 1).max() < 2.0**-14


def test_f64_dense_sandwich_parity_at_benchmark_width(gpu_device):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((1_000_000, 50))
    d = rng.random(1_000_000)
    got = np.asarray(tm.DenseMatrix(X).sandwich(jnp.asarray(d)))
    ref = (X * d[:, None]).T @ X
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-11
