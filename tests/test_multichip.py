"""Multi-device sharding tests on the 8-device virtual CPU mesh.

Validates that row-sharded ('dp') and column-sharded ('mp') executions of
the core ops and the full mixed-design IRLS step match single-device
results — the contract ``chip_smoke.py --four-cards`` checks on four GPUs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import tabmat_tpu as tm
from tabmat_tpu.ops import dense_ops
from tabmat_tpu.parallel import (
    MixedDesign,
    build_mixed_design,
    make_mesh,
    mixed_irls_step,
    replicate,
    shard_rows,
)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8, mp=2)


def test_row_sharded_sandwich_matches(mesh):
    rng = np.random.default_rng(0)
    n, k = 1024, 6
    X_np = rng.standard_normal((n, k))
    d_np = rng.random(n)
    ref = (X_np * d_np[:, None]).T @ X_np

    X = jax.device_put(jnp.asarray(X_np), NamedSharding(mesh, P("dp", None)))
    d = jax.device_put(jnp.asarray(d_np), NamedSharding(mesh, P("dp")))
    with mesh:
        S = dense_ops.sandwich(X, d)
    np.testing.assert_allclose(np.asarray(S), ref, atol=1e-11)


def test_row_and_col_sharded_sandwich(mesh):
    rng = np.random.default_rng(1)
    n, k = 512, 8
    X_np = rng.standard_normal((n, k))
    d_np = rng.random(n)
    X = jax.device_put(jnp.asarray(X_np), NamedSharding(mesh, P("dp", "mp")))
    d = jax.device_put(jnp.asarray(d_np), NamedSharding(mesh, P("dp")))
    with mesh:
        S = dense_ops.sandwich(X, d)
    np.testing.assert_allclose(
        np.asarray(S), (X_np * d_np[:, None]).T @ X_np, atol=1e-11
    )


def test_sharded_segment_plan_sum(mesh):
    """Categorical segment reduction under row sharding."""
    from tabmat_tpu.ops.segments import build_plan

    rng = np.random.default_rng(2)
    n, K = 4096, 32
    codes = rng.integers(0, K, n)
    plan = build_plan(codes, K)
    v_np = rng.random(n)
    v = jax.device_put(jnp.asarray(v_np), NamedSharding(mesh, P("dp")))
    with mesh:
        out = plan.sum(v)
    ref = np.bincount(codes, weights=v_np, minlength=K)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-11)


def test_mixed_design_step_matches_single_device(mesh):
    n, kd, ks, kc = 512, 8, 6, 10
    dz = build_mixed_design(n, kd, ks, kc, seed=1)
    rng = np.random.default_rng(3)
    y = jnp.asarray(rng.poisson(2.0, n).astype(np.float64))
    w = jnp.ones(n, dtype=jnp.float64)
    beta = jnp.zeros(kd + ks + kc, dtype=jnp.float64)

    ref = mixed_irls_step(dz, y, w, beta, family="poisson", n_cg=6)

    dz_sharded = MixedDesign(
        dense=jax.device_put(dz.dense, NamedSharding(mesh, P("dp", "mp"))),
        sp_csr_data=replicate(dz.sp_csr_data, mesh),
        sp_csr_cols=replicate(dz.sp_csr_cols, mesh),
        sp_csr_bounds=replicate(dz.sp_csr_bounds, mesh),
        sp_csc_data=replicate(dz.sp_csc_data, mesh),
        sp_csc_rows=replicate(dz.sp_csc_rows, mesh),
        sp_csc_bounds=replicate(dz.sp_csc_bounds, mesh),
        cat_codes=shard_rows(dz.cat_codes, mesh),
        cat_perm=shard_rows(dz.cat_perm, mesh),
        cat_bounds=replicate(dz.cat_bounds, mesh),
    )
    with mesh:
        res = mixed_irls_step(
            dz_sharded,
            shard_rows(y, mesh),
            shard_rows(w, mesh),
            replicate(beta, mesh),
            family="poisson",
            n_cg=6,
        )
        res.block_until_ready()
    np.testing.assert_allclose(np.asarray(res), np.asarray(ref), rtol=1e-8)


def test_shard_map_sandwich(mesh):
    from tabmat_tpu.parallel.shard_ops import place_row_sharded, sharded_sandwich

    rng = np.random.default_rng(10)
    n, k = 2048, 7
    X_np = rng.standard_normal((n, k))
    d_np = rng.random(n)
    X, d = place_row_sharded(mesh, jnp.asarray(X_np), jnp.asarray(d_np))
    S = sharded_sandwich(X, d, mesh)
    np.testing.assert_allclose(
        np.asarray(S), (X_np * d_np[:, None]).T @ X_np, atol=1e-11
    )


def test_shard_map_tmv(mesh):
    from tabmat_tpu.parallel.shard_ops import (
        place_row_sharded,
        sharded_transpose_matvec,
    )

    rng = np.random.default_rng(11)
    n, k = 1024, 5
    X_np = rng.standard_normal((n, k))
    v_np = rng.standard_normal(n)
    X, v = place_row_sharded(mesh, jnp.asarray(X_np), jnp.asarray(v_np))
    out = sharded_transpose_matvec(X, v, mesh)
    np.testing.assert_allclose(np.asarray(out), X_np.T @ v_np, atol=1e-11)


def test_shard_map_segment_sum(mesh):
    from tabmat_tpu.parallel.shard_ops import place_row_sharded, sharded_segment_sum

    rng = np.random.default_rng(12)
    n, K = 4096, 17
    codes = rng.integers(0, K, n).astype(np.int32)
    vals = rng.random(n)
    v, c = place_row_sharded(mesh, jnp.asarray(vals), jnp.asarray(codes))
    out = sharded_segment_sum(v, c, K, mesh)
    np.testing.assert_allclose(
        np.asarray(out), np.bincount(codes, weights=vals, minlength=K), atol=1e-11
    )


def test_user_path_sharded_irls(mesh):
    """SplitMatrix -> DeviceDesign.shard -> irls_step: the user multichip path."""
    _check_user_path(mesh, dense_cols="mp")


def test_user_path_rows_only_layout():
    """The same step with rows over all 8 devices and replicated columns."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    _check_user_path(make_mesh(8, mp=1), dense_cols=None)


def _check_user_path(mesh, dense_cols):
    from scipy import sparse as sps

    import tabmat_tpu as tm
    from tabmat_tpu.glm import irls_step
    from tabmat_tpu.parallel.design import DeviceDesign

    rng = np.random.default_rng(21)
    n, kd, kc = 1024, 4, 9
    split = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, kd))),
            tm.SparseMatrix(sps.random(n, 5, density=0.1, random_state=4, format="csc")),
            tm.CategoricalMatrix(
                rng.integers(0, kc, n).astype(np.int32), categories=np.arange(kc)
            ),
        ]
    )
    design = DeviceDesign.from_matrix(split)
    y = jnp.asarray(rng.poisson(1.5, n).astype(np.float64))
    w = jnp.ones(n, dtype=jnp.float64)
    b0 = jnp.zeros(split.shape[1], dtype=jnp.float64)
    ref = np.asarray(
        irls_step(design, y, w, b0, family="poisson", n_cg=5, inner_precision="float64")
    )

    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = design.shard(mesh, rows="dp", dense_cols=dense_cols)
    # every shard of the dense block lives on its own device
    held = {s.device for s in sharded.blocks[0].arrays["X"].addressable_shards}
    assert len(held) == 8
    rows = lambda x: jax.device_put(x, NamedSharding(mesh, P("dp")))  # noqa: E731
    with mesh:
        got = irls_step(
            sharded,
            rows(y),
            rows(w),
            jax.device_put(b0, NamedSharding(mesh, P())),
            family="poisson",
            n_cg=5,
            inner_precision="float64",
        )
        got.block_until_ready()
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-8, atol=1e-10)
