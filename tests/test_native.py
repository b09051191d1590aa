"""Native host-helper tests (counting argsort, is_sorted, combine_codes, build)."""

import os
import platform

import numpy as np
import pytest

from tabmat_tpu import _native


def test_counting_argsort_matches_numpy():
    rng = np.random.default_rng(0)
    keys = rng.integers(-1, 50, 10_000).astype(np.int32)
    perm, bounds = _native.counting_argsort(keys, 50)
    ref_perm = np.argsort(keys, kind="stable")
    ref_bounds = np.searchsorted(keys[ref_perm], np.arange(51))
    np.testing.assert_array_equal(perm, ref_perm)
    np.testing.assert_array_equal(bounds, ref_bounds)


def test_counting_argsort_empty():
    perm, bounds = _native.counting_argsort(np.array([], dtype=np.int32), 5)
    assert len(perm) == 0
    np.testing.assert_array_equal(bounds, np.zeros(6, dtype=np.int32))


def test_is_sorted():
    assert _native.is_sorted(np.array([1, 2, 2, 3]))
    assert not _native.is_sorted(np.array([1, 0]))
    assert _native.is_sorted(np.array([], dtype=np.int64))


def test_combine_codes():
    a = np.array([0, 1, -1, 2], dtype=np.int32)
    b = np.array([1, -1, 0, 2], dtype=np.int32)
    out = _native.combine_codes(a, b, 3)
    np.testing.assert_array_equal(out, [1, -1, -1, 8])


def test_sparse_walks_match_scipy():
    """OpenMP CSR matvec / CSC tmv match scipy exactly on f64."""
    import scipy.sparse as sps

    from tabmat_tpu import _native

    rng = np.random.default_rng(3)
    A = sps.random(5000, 37, density=0.03, format="csc", random_state=7)
    csr = A.tocsr()
    v = rng.standard_normal(37)
    r = rng.standard_normal(5000)
    got_mv = _native.csr_matvec(
        csr.data, csr.indices, csr.indptr, 5000, v
    )
    got_tmv = _native.csc_tmv(A.data, A.indices, A.indptr, 37, r)
    if got_mv is None:  # no native lib on this host: fallback contract
        assert got_tmv is None
        return
    np.testing.assert_allclose(got_mv, csr @ v, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got_tmv, A.T @ r, rtol=1e-13, atol=1e-13)
    # out= accumulates in place
    out = np.ones(37)
    res = _native.csc_tmv(A.data, A.indices, A.indptr, 37, r, out=out)
    assert res is out
    np.testing.assert_allclose(out, 1.0 + A.T @ r, rtol=1e-13)


def test_sparse_host_walk_class_route():
    """Numpy callers ride the host walk incl. rows/cols/out contracts."""
    import scipy.sparse as sps

    import tabmat_tpu as tm

    rng = np.random.default_rng(4)
    A = sps.random(3000, 21, density=0.05, format="csc", random_state=9)
    m = tm.SparseMatrix(A)
    D = A.toarray()
    v = rng.standard_normal(21)
    r = rng.standard_normal(3000)
    np.testing.assert_allclose(m.matvec(v), D @ v, rtol=1e-12)
    np.testing.assert_allclose(m.transpose_matvec(r), D.T @ r, rtol=1e-12)
    rows = np.arange(0, 3000, 3)
    cols = np.array([2, 5, 19])
    np.testing.assert_allclose(
        m.transpose_matvec(r, rows=rows, cols=cols),
        D[rows][:, cols].T @ r[rows],
        rtol=1e-12,
    )
    out = np.full(21, 2.0)
    m.transpose_matvec(r, out=out)
    np.testing.assert_allclose(out, 2.0 + D.T @ r, rtol=1e-12)
    out2 = np.full(3000, -1.0)
    m.matvec(v, cols=cols, out=out2)
    vm = np.zeros(21)
    vm[cols] = v[cols]
    np.testing.assert_allclose(out2, -1.0 + D @ vm, rtol=1e-12)


def test_library_path_keyed_by_source_flags_and_host(monkeypatch):
    base = _native.library_path()
    assert os.path.dirname(base) == _native._BUILD_DIR
    monkeypatch.setattr(_native, "_FLAGS", _native._FLAGS + ("-DVARIANT",))
    flagged = _native.library_path()
    monkeypatch.undo()
    monkeypatch.setattr(platform, "node", lambda: "some-other-host")
    moved = _native.library_path()
    assert len({base, flagged, moved}) == 3


def test_portable_flags_only():
    assert not any(f.startswith("-march") for f in _native._FLAGS)


def test_library_built_elsewhere_is_never_loaded(monkeypatch, tmp_path):
    """A key mismatch means a rebuild, never loading the old library."""
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(platform, "node", lambda: "host-a")
    stale = _native.library_path()
    with open(stale, "wb") as f:
        f.write(b"not a shared library")
    monkeypatch.setattr(platform, "node", lambda: "host-b")
    monkeypatch.setenv("TABMAT_TPU_NO_NATIVE_BUILD", "1")
    assert _native._load() is None  # the host-a file is not touched
    assert os.listdir(tmp_path) == [os.path.basename(stale)]


def test_rebuild_when_key_differs(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(platform, "node", lambda: "fresh-host")
    monkeypatch.delenv("TABMAT_TPU_NO_NATIVE_BUILD", raising=False)
    lib = _native._load()
    if lib is None:  # no compiler on this host: the numpy fallbacks serve
        pytest.skip("no C++ compiler")
    assert os.path.exists(_native.library_path())
    assert os.path.dirname(_native.library_path()) == str(tmp_path)
    keys = np.array([2, 0, 1, 0], dtype=np.int32)
    perm, bounds = _native.counting_argsort(keys, 3)
    np.testing.assert_array_equal(perm, [1, 3, 2, 0])
    np.testing.assert_array_equal(bounds, [0, 2, 3, 4])


def test_build_dir_is_git_ignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "tabmat_tpu/_native/build/" in f.read().split()
