"""DeviceDesign: traceable matvec/tmv parity + jitted GLM on mixed designs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import sparse as sps

import tabmat_tpu as tm
from tabmat_tpu.glm import fit_glm, irls_step
from tabmat_tpu.parallel.design import DeviceDesign


def make_split(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, 3))),
            tm.SparseMatrix(sps.random(n, 4, density=0.3, random_state=seed)),
            tm.CategoricalMatrix(rng.integers(0, 5, n), categories=np.arange(5)),
        ],
        [np.array([0, 3, 6]), np.array([1, 4, 7, 8]), np.array([2, 5, 9, 10, 11])],
    )


@pytest.mark.parametrize(
    "make",
    [
        lambda: tm.DenseMatrix(np.random.default_rng(0).standard_normal((40, 5))),
        lambda: tm.SparseMatrix(sps.random(40, 5, density=0.3, random_state=0)),
        lambda: tm.CategoricalMatrix(
            np.random.default_rng(0).integers(0, 5, 40), categories=np.arange(5)
        ),
        make_split,
    ],
    ids=["dense", "sparse", "cat", "split"],
)
def test_matvec_tmv_parity(make):
    mat = make()
    design = DeviceDesign.from_matrix(mat)
    arr = mat.toarray()
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.standard_normal(mat.shape[1]))
    r = jnp.asarray(rng.standard_normal(mat.shape[0]))
    np.testing.assert_allclose(np.asarray(design @ v), arr @ np.asarray(v), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(design.T @ r), arr.T @ np.asarray(r), atol=1e-12
    )


def test_standardized_design():
    mat = make_split()
    w = np.full(mat.shape[0], 1 / mat.shape[0])
    std, _, _ = mat.standardize(w, True, True)
    design = DeviceDesign.from_matrix(std)
    arr = std.toarray()
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.standard_normal(mat.shape[1]))
    r = jnp.asarray(rng.standard_normal(mat.shape[0]))
    np.testing.assert_allclose(np.asarray(design @ v), arr @ np.asarray(v), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(design.T @ r), arr.T @ np.asarray(r), atol=1e-12
    )


def test_design_is_jittable():
    mat = make_split()
    design = DeviceDesign.from_matrix(mat)

    @jax.jit
    def f(d, v):
        return d @ v

    v = jnp.asarray(np.random.default_rng(0).standard_normal(mat.shape[1]))
    np.testing.assert_allclose(
        np.asarray(f(design, v)), mat.toarray() @ np.asarray(v), atol=1e-12
    )


def test_glm_on_split_matrix():
    rng = np.random.default_rng(3)
    mat = make_split(n=400, seed=3)
    arr = mat.toarray()
    beta_true = rng.standard_normal(mat.shape[1]) * 0.5
    y = arr @ beta_true + 0.01 * rng.standard_normal(400)
    beta, n_iter = fit_glm(mat, y, family="gaussian", n_cg=60, l2=1e-10)
    ref = np.linalg.lstsq(arr, np.asarray(y), rcond=None)[0]
    np.testing.assert_allclose(np.asarray(beta), ref, atol=1e-5)


def test_irls_step_jit_on_design():
    mat = make_split(n=200, seed=4)
    design = DeviceDesign.from_matrix(mat)
    rng = np.random.default_rng(5)
    y = jnp.asarray(rng.poisson(1.5, 200).astype(np.float64))
    w = jnp.ones(200, dtype=jnp.float64)
    beta = jnp.zeros(mat.shape[1], dtype=jnp.float64)
    out = irls_step(design, y, w, beta, family="poisson", n_cg=5)
    assert np.all(np.isfinite(np.asarray(out)))


def test_stacked_categoricals_parity():
    """Multiple cat blocks merge into one flat pseudo-categorical."""
    rng = np.random.default_rng(9)
    n = 80
    mat = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, 2))),
            tm.CategoricalMatrix(rng.integers(0, 4, n), categories=np.arange(4)),
            tm.CategoricalMatrix(
                rng.integers(0, 6, n), categories=np.arange(6), drop_first=True
            ),
            tm.CategoricalMatrix(
                np.where(rng.random(n) < 0.2, -1, rng.integers(0, 3, n)),
                categories=np.arange(3),
                cat_missing_method="zero",
            ),
        ]
    )
    design = DeviceDesign.from_matrix(mat)
    kinds = [b.kind for b in design.blocks]
    assert kinds.count("catstack") == 1 and "cat" not in kinds
    arr = mat.toarray()
    rng2 = np.random.default_rng(10)
    v = jnp.asarray(rng2.standard_normal(mat.shape[1]))
    r = jnp.asarray(rng2.standard_normal(n))
    np.testing.assert_allclose(np.asarray(design @ v), arr @ np.asarray(v), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(design.T @ r), arr.T @ np.asarray(r), atol=1e-12
    )
    # jitted + f32 view still consistent
    d32 = design.astype_float(jnp.float32)
    np.testing.assert_allclose(
        np.asarray(d32 @ v.astype(jnp.float32)), arr @ np.asarray(v), rtol=1e-4, atol=1e-4
    )


def test_design_sandwich_explicit():
    """Traceable explicit sandwich matches the dense oracle."""
    rng = np.random.default_rng(40)
    n = 120
    mat = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, 3))),
            tm.CategoricalMatrix(rng.integers(0, 5, n), categories=np.arange(5)),
            tm.CategoricalMatrix(rng.integers(0, 4, n), categories=np.arange(4)),
        ],
        [np.array([0, 4, 8]), np.array([1, 2, 3, 5, 6]), np.array([7, 9, 10, 11])],
    )
    design = DeviceDesign.from_matrix(mat)
    assert design.supports_sandwich
    w = jnp.asarray(rng.random(n))
    H = np.asarray(design.sandwich(w))
    arr = mat.toarray()
    ref = (arr * np.asarray(w)[:, None]).T @ arr
    np.testing.assert_allclose(H, ref, atol=1e-11)
    # and under jit
    H2 = np.asarray(jax.jit(lambda d, w: d.sandwich(w))(design, w))
    np.testing.assert_allclose(H2, ref, atol=1e-11)


def test_design_sandwich_single_cat():
    rng = np.random.default_rng(41)
    n = 60
    mat = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, 2))),
            tm.CategoricalMatrix(rng.integers(0, 3, n), categories=np.arange(3)),
        ]
    )
    design = DeviceDesign.from_matrix(mat)
    assert design.supports_sandwich
    w = jnp.asarray(rng.random(n))
    arr = mat.toarray()
    np.testing.assert_allclose(
        np.asarray(design.sandwich(w)),
        (arr * np.asarray(w)[:, None]).T @ arr,
        atol=1e-12,
    )


def test_design_sandwich_with_sparse_block():
    """dense+sparse+cat mix: the sparse arms of the unit grid are exact."""
    mat = make_split()  # dense + sparse + cat, interleaved global columns
    design = DeviceDesign.from_matrix(mat)
    assert design.supports_sandwich
    rng = np.random.default_rng(7)
    w = jnp.asarray(rng.random(mat.shape[0]))
    arr = mat.toarray()
    ref = (arr * np.asarray(w)[:, None]).T @ arr
    np.testing.assert_allclose(np.asarray(design.sandwich(w)), ref, atol=1e-11)
    H2 = np.asarray(jax.jit(lambda d, wt: d.sandwich(wt))(design, w))
    np.testing.assert_allclose(H2, ref, atol=1e-11)


def test_design_sandwich_sparse_two_cats_drop_first():
    """sparse×cat cross plans with negative (dropped) codes stay exact."""
    rng = np.random.default_rng(43)
    n = 200
    mat = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, 2))),
            tm.SparseMatrix(sps.random(n, 5, density=0.15, random_state=1)),
            tm.CategoricalMatrix(rng.integers(0, 6, n), categories=np.arange(6)),
            tm.CategoricalMatrix(
                rng.integers(0, 4, n), categories=np.arange(4), drop_first=True
            ),
        ]
    )
    design = DeviceDesign.from_matrix(mat)
    assert design.supports_sandwich
    w = jnp.asarray(rng.random(n))
    arr = mat.toarray()
    ref = (arr * np.asarray(w)[:, None]).T @ arr
    np.testing.assert_allclose(np.asarray(design.sandwich(w)), ref, atol=1e-11)


def test_design_sandwich_sparse_cat_no_dense():
    """A sparse block without a dense block stays sparse-kind and sandwiches."""
    rng = np.random.default_rng(44)
    n = 150
    mat = tm.SplitMatrix(
        [
            tm.SparseMatrix(sps.random(n, 6, density=0.2, random_state=2)),
            tm.CategoricalMatrix(rng.integers(0, 5, n), categories=np.arange(5)),
        ]
    )
    design = DeviceDesign.from_matrix(mat)
    assert any(b.kind == "sparse" for b in design.blocks)
    assert design.supports_sandwich
    w = jnp.asarray(rng.random(n))
    arr = mat.toarray()
    ref = (arr * np.asarray(w)[:, None]).T @ arr
    np.testing.assert_allclose(np.asarray(design.sandwich(w)), ref, atol=1e-11)


def test_irls_explicit_h_matches_hvp_path():
    rng = np.random.default_rng(42)
    n = 500
    # full-rank design: second categorical drops its reference level
    mat = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, 3))),
            tm.CategoricalMatrix(rng.integers(0, 6, n), categories=np.arange(6)),
            tm.CategoricalMatrix(
                rng.integers(0, 5, n), categories=np.arange(5), drop_first=True
            ),
        ]
    )
    design = DeviceDesign.from_matrix(mat)
    y = jnp.asarray(rng.poisson(1.2, n).astype(np.float64))
    w = jnp.ones(n, dtype=jnp.float64)
    beta = jnp.asarray(rng.standard_normal(mat.shape[1]) * 0.01)
    explicit = irls_step(design, y, w, beta, family="poisson", n_cg=30)
    # hvp reference on the densified design (same CG count)
    Xd = jnp.asarray(mat.toarray())
    ref = irls_step(
        Xd, y, w, beta, family="poisson", n_cg=30, inner_precision="float64"
    )
    np.testing.assert_allclose(np.asarray(explicit), np.asarray(ref), atol=1e-6)
