"""ctypes loader for the native host helpers (with pure-numpy fallbacks).

The shared library is compiled from ``segment_helpers.cpp`` on first use
into ``build/`` beside this file.  Its file name carries a hash of the
source, the compiler flags and the host, so a library built from other
sources or on another machine is never loaded: a new key means a fresh
build.  If the build fails, every entry point falls back to numpy, so the
package works on any host.
"""

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "segment_helpers.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
# portable code generation: no -march=native, the library may be built on
# one x86-64 host and must still be valid on the next
_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> str:
    """Where the library for this source, these flags and this host lives."""
    key = hashlib.sha256()
    with open(_SOURCE, "rb") as f:
        key.update(f.read())
    key.update(" ".join(_FLAGS).encode())
    key.update(
        f"{platform.system()} {platform.machine()} {platform.node()}".encode()
    )
    return os.path.join(
        _BUILD_DIR, f"libtabmat_tpu_native-{key.hexdigest()[:16]}.so"
    )


def _build(path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"  # concurrent builders never clash
    subprocess.run(
        ["g++", *_FLAGS, _SOURCE, "-o", tmp],
        capture_output=True,
        timeout=120,
        check=True,
    )
    os.replace(tmp, path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        if os.environ.get("TABMAT_TPU_NO_NATIVE_BUILD", "0") == "1":
            return None
        try:
            _build(path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(path)
        lib.counting_argsort_i32.restype = ctypes.c_int
        lib.counting_argsort_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.is_sorted_i64.restype = ctypes.c_int
        lib.is_sorted_i64.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.combine_codes_i32.restype = None
        lib.combine_codes_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.expand_pairs_csr_i64.restype = None
        lib.expand_pairs_csr_i64.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _walk_args = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
        ]
        for name in ("csr_matvec_f64", "csc_tmv_f64"):
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.restype = None
                fn.argtypes = _walk_args
        _lib = lib
        return lib
    except OSError:
        return None


def available() -> bool:
    """True when the native library loaded."""
    return _load() is not None


def counting_argsort(keys: np.ndarray, num_segments: int):
    """Stable argsort + segment bounds for bounded int keys.

    Returns (perm int32 (n,), bounds int32 (num_segments+1,)).  Native
    O(n + K) counting sort when available; numpy argsort fallback.
    """
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    lib = _load()
    if lib is not None:
        n = len(keys)
        perm = np.empty(n, dtype=np.int32)
        bounds = np.empty(num_segments + 1, dtype=np.int32)
        rc = lib.counting_argsort_i32(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            num_segments,
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc == 0:
            return perm, bounds
    perm = np.argsort(keys, kind="stable").astype(np.int32)
    sorted_keys = keys[perm]
    bounds = np.searchsorted(
        sorted_keys, np.arange(num_segments + 1, dtype=keys.dtype)
    ).astype(np.int32)
    return perm, bounds


def is_sorted(arr: np.ndarray) -> bool:
    """Non-decreasing check (native loop or numpy diff)."""
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    lib = _load()
    if lib is not None:
        return bool(
            lib.is_sorted_i64(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(arr)
            )
        )
    return not np.any(np.diff(arr) < 0)


def expand_pairs_csr(indptr: np.ndarray):
    """All ordered within-row nonzero pairs of a CSR structure.

    Returns (ia, ib, row) int32 arrays of length sum(nnz_r^2): positions of
    the pair members in the data array and the owning row.  Native loop when
    available; vectorized numpy fallback.
    """
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    n_rows = len(indptr) - 1
    counts = np.diff(indptr)
    n_pairs = int((counts * counts).sum())
    lib = _load()
    if lib is not None:
        ia = np.empty(n_pairs, dtype=np.int32)
        ib = np.empty(n_pairs, dtype=np.int32)
        row = np.empty(n_pairs, dtype=np.int32)
        lib.expand_pairs_csr_i64(
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_rows,
            ia.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ib.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return ia, ib, row
    # numpy fallback: per-pair local indices via cumsum arithmetic
    pair_counts = counts * counts
    row = np.repeat(np.arange(n_rows, dtype=np.int64), pair_counts)
    pair_starts = np.concatenate([[0], np.cumsum(pair_counts)])
    q = np.arange(n_pairs, dtype=np.int64) - pair_starts[row]
    c_r = counts[row]
    a_local = q // np.maximum(c_r, 1)
    b_local = q % np.maximum(c_r, 1)
    start = indptr[row]
    return (
        (start + a_local).astype(np.int32),
        (start + b_local).astype(np.int32),
        row.astype(np.int32),
    )


def _sparse_walk(fn_name, data, indices, indptr, n_out, vec, out):
    """Shared caller of the OpenMP CSR/CSC walks (None → no native lib)."""
    lib = _load()
    if lib is None or getattr(lib, fn_name, None) is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    vec = np.ascontiguousarray(vec, dtype=np.float64)
    accumulate = out is not None
    res = out if accumulate else np.empty(n_out, dtype=np.float64)
    getattr(lib, fn_name)(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_out,
        vec.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        1 if accumulate else 0,
    )
    return res


def csr_matvec(data, indices, indptr, n_rows, v, out=None):
    """OpenMP ``A_csr @ v`` (f64). ``out`` accumulates in place.

    Returns None when the native library is unavailable (caller falls
    back to its scipy path). Host fast path for numpy-caller matvec —
    counterpart of the reference's per-call C walk
    (``tabmat/ext/sparse.pyx:129-156``).
    """
    if out is not None and (
        out.dtype != np.float64 or not out.flags["C_CONTIGUOUS"]
    ):
        return None
    return _sparse_walk("csr_matvec_f64", data, indices, indptr, n_rows, v, out)


def csc_tmv(data, indices, indptr, n_cols, r, out=None):
    """OpenMP ``A_csc.T @ r`` (f64). ``out`` accumulates in place.

    Returns None when the native library is unavailable. Counterpart of
    ``tabmat/ext/sparse.pyx:159-199``.
    """
    if out is not None and (
        out.dtype != np.float64 or not out.flags["C_CONTIGUOUS"]
    ):
        return None
    return _sparse_walk("csc_tmv_f64", data, indices, indptr, n_cols, r, out)


def combine_codes(a: np.ndarray, b: np.ndarray, k2: int) -> np.ndarray:
    """Combined categorical cross keys: ``a*k2 + b`` where both valid, else -1.

    Contract: returns int32 on both the native and numpy paths.  Callers must
    guarantee ``max(a)*k2 + max(b) < 2**31`` (the cat×cat cross-sandwich
    guards ``K1*K2 <= 2**31`` before calling); this is asserted here so a
    silent wraparound can never produce wrong keys.
    """
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    if len(a) and int(a.max()) * k2 + max(int(b.max()), 0) >= 2**31:
        raise OverflowError(
            f"combined categorical key space {int(a.max()) + 1}*{k2} exceeds "
            "int32; reduce the category product below 2**31"
        )
    lib = _load()
    if lib is not None:
        out = np.empty(len(a), dtype=np.int32)
        lib.combine_codes_i32(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(a),
            k2,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out
    out = np.where((a >= 0) & (b >= 0), a.astype(np.int64) * k2 + b, -1)
    return out.astype(np.int32)
