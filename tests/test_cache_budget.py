"""Global device-cache budget ledger (_config.cache_charge).

The ledger itself is platform-independent; cache build sites (the dense
mirror in models/sparse.py) consult it via ``cache_charge(bytes, owner)``
and fall back to their cache-free routes when refused.
"""

import gc

import numpy as np
import pytest

from tabmat_tpu import _config


@pytest.fixture(autouse=True)
def _reset_budget():
    _config.set_cache_budget_mb(None)
    _config._cache_refund(_config.cache_spent_bytes())
    yield
    _config.set_cache_budget_mb(None)
    _config._cache_refund(_config.cache_spent_bytes())


def test_unlimited_by_default():
    assert _config.cache_budget_bytes() is None
    assert _config.cache_charge(1 << 40) is True  # never refused
    assert _config.cache_spent_bytes() == 0  # unlimited → nothing ledgered


def test_budget_refuses_past_cap():
    _config.set_cache_budget_mb(1)  # 1 MB
    assert _config.cache_charge(512 * 1024) is True
    assert _config.cache_spent_bytes() == 512 * 1024
    assert _config.cache_charge(768 * 1024) is False  # would exceed
    assert _config.cache_spent_bytes() == 512 * 1024
    assert _config.cache_charge(512 * 1024) is True  # exactly fills
    assert _config.cache_charge(1) is False


def test_refund_on_owner_gc():
    _config.set_cache_budget_mb(1)

    class Owner:
        pass

    o = Owner()
    assert _config.cache_charge(1 << 20, owner=o) is True
    assert _config.cache_charge(1, owner=Owner()) is False
    del o
    gc.collect()
    assert _config.cache_spent_bytes() == 0
    assert _config.cache_charge(1 << 20) is True


def test_budgeted_matrix_still_correct():
    # with a zero budget every structural cache is refused; results must
    # come from the cache-free routes bit-for-bit valid
    import tabmat_tpu as tm

    _config.set_cache_budget_mb(0)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((500, 8))
    d = rng.random(500)
    m = tm.DenseMatrix(X)
    np.testing.assert_allclose(
        np.asarray(m.sandwich(d)), X.T @ (d[:, None] * X), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(m.transpose_matvec(d)), X.T @ d, rtol=1e-12
    )
    assert _config.cache_spent_bytes() == 0
