"""Every f32 contraction of the compute path lowers at HIGHEST precision.

XLA may run a float32 dot in TF32 (10-bit mantissa) on the GPU unless its
precision is pinned, which would silently cost f32 designs their accuracy.
These tests lower each route on the CPU and check that every
``dot_general`` in the program carries ``HIGHEST``.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import tabmat_tpu as tm
from tabmat_tpu.glm import irls_step
from tabmat_tpu.ops import dense_ops
from tabmat_tpu.parallel.design import DeviceDesign
from tabmat_tpu.parallel.distributed import (
    build_mixed_design,
    design_matvec,
    design_transpose_matvec,
)

F32 = jnp.float32


def _dots(fn, *args):
    text = jax.jit(fn).lower(*args).as_text()
    return [line for line in text.splitlines() if "dot_general" in line]


def _assert_pinned(fn, *args):
    dots = _dots(fn, *args)
    assert dots, "expected at least one contraction"
    unpinned = [d for d in dots if not re.search("HIGHEST", d)]
    assert not unpinned, unpinned


def _split32(n=64):
    rng = np.random.default_rng(0)
    split = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, 3))),
            tm.CategoricalMatrix(rng.integers(0, 4, n), categories=np.arange(4)),
        ]
    )
    return split, DeviceDesign.from_matrix(split).astype_float(F32)


X32 = jnp.ones((64, 5), F32)
V32 = jnp.ones(5, F32)
R32 = jnp.ones(64, F32)


@pytest.mark.parametrize(
    "name,fn,args",
    [
        ("matmul", dense_ops.matmul, (X32, V32)),
        ("sandwich", dense_ops.sandwich, (X32, R32)),
        ("matvec", dense_ops.matvec, (X32, V32)),
        ("transpose_matvec", dense_ops.transpose_matvec, (X32, R32)),
        ("sandwich_restricted",
         lambda X, d: dense_ops.sandwich_restricted(X, d, None, np.array([0, 2]))[0],
         (X32, R32)),
    ],
)
def test_dense_ops_routes_pinned(name, fn, args):
    _assert_pinned(fn, *args)


@pytest.mark.parametrize("op", ["matvec", "transpose_matvec", "sandwich"])
def test_device_design_dense_terms_pinned(op):
    _, d32 = _split32()
    arg = {"matvec": jnp.ones(7, F32)}.get(op, jnp.ones(64, F32))
    _assert_pinned(lambda dd, a: getattr(dd, op)(a), d32, arg)


def test_device_design_standardized_shift_pinned():
    split, _ = _split32()
    std, _, _ = split.standardize(np.full(64, 1 / 64), True, True)
    d32 = DeviceDesign.from_matrix(std).astype_float(F32)
    _assert_pinned(lambda dd, v: dd.matvec(v), d32, jnp.ones(7, F32))


@pytest.mark.parametrize("route", ["explicit_hessian", "array_hvp", "design_hvp"])
def test_irls_step_f32_inner_pinned(route):
    """The default f32 inner solve of an f64 design: H @ v, X32 matvecs, CG dots."""
    split, _ = _split32()
    if route == "explicit_hessian":
        X = DeviceDesign.from_matrix(split)
        assert X.supports_sandwich
    elif route == "array_hvp":
        X = jnp.asarray(split.toarray())
    else:
        std, _, _ = split.standardize(np.full(64, 1 / 64), True, True)
        X = DeviceDesign.from_matrix(std)
        assert not X.supports_sandwich
    y, w, b = jnp.ones(64), jnp.ones(64), jnp.zeros(7)
    dots = _dots(
        lambda X, y, w, b: irls_step(X, y, w, b, family="poisson", n_cg=2), X, y, w, b
    )
    f32_dots = [d for d in dots if "f32" in d]
    assert f32_dots
    assert all("HIGHEST" in d for d in f32_dots), f32_dots


def test_dense_matrix_matmul_and_ops_pinned():
    m = tm.DenseMatrix(np.ones((64, 5), np.float32))
    _assert_pinned(lambda v: m @ v, V32)
    _assert_pinned(lambda d: m.sandwich(d), R32)


def test_sparse_dense_mirror_sandwich_pinned():
    rng = np.random.default_rng(1)
    A = (rng.random((64, 6)) < 0.5) * rng.standard_normal((64, 6))
    m = tm.SparseMatrix(A.astype(np.float32))
    mirror = m._dense_mirror()
    _assert_pinned(
        lambda X, d: dense_ops.sandwich_restricted(X, d, None, None)[0], mirror, R32
    )


def test_standardized_matrix_shift_part_pinned():
    split, _ = _split32()
    std, _, _ = split.standardize(np.full(64, 1 / 64), True, True)
    _assert_pinned(lambda v: std.matvec(v), jnp.ones(7, F32))


def test_distributed_mixed_design_pinned():
    dz = build_mixed_design(64, 3, 2, 4)
    dz32 = jax.tree.map(
        lambda a: a.astype(F32) if jnp.issubdtype(a.dtype, jnp.floating) else a, dz
    )
    _assert_pinned(lambda d, v: design_matvec(d, v), dz32, jnp.ones(9, F32))
    _assert_pinned(lambda d, r: design_transpose_matvec(d, r), dz32, jnp.ones(64, F32))
