"""Global configuration for tabmat-tpu.

The reference library (Quantco/tabmat) is float64-by-default: every matrix
constructor defaults to ``np.float64`` and the test-suite checks 12-decimal
parity (see reference ``tests/test_real_matrix.py:22``), so JAX runs in x64
mode.  We enable it at import time unless the user opts out via
``TABMAT_TPU_NO_X64=1``.

We also enable JAX's persistent compilation cache: where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps the cache there and this
module sets no other directory; otherwise the cache lives at one fixed
path inside the checkout (:func:`default_compilation_cache_dir`).  Opt out
with ``TABMAT_TPU_NO_COMPILATION_CACHE=1``.
"""

import os
import threading
import weakref

import jax

_initialized = False

# ---------------------------------------------------------------------------
# Global structural-cache budget (device memory).
#
# Matrix classes may build device-resident structural caches (the dense
# mirror of a sparse matrix).  They are pure speed: every route has a
# cache-free fallback.  ``TABMAT_TPU_CACHE_BUDGET_MB`` (or
# :func:`set_cache_budget_mb`) caps the TOTAL bytes charged across all
# live matrices; once the ledger is full, further builds are refused and
# the owners take their cache-free routes.  Refunds happen when the owning
# matrix is garbage-collected.  Default: unlimited (no behavior change).
# Per-matrix cost table: docs/benchmarks/README.md §"Device cache costs".
# ---------------------------------------------------------------------------

_budget_lock = threading.Lock()
_cache_budget = "unset"  # lazy env read; None = unlimited; else bytes
_cache_spent = 0


def set_cache_budget_mb(mb) -> None:
    """Set (or clear, with ``None``) the global device-cache budget."""
    global _cache_budget
    with _budget_lock:
        _cache_budget = None if mb is None else int(float(mb) * (1 << 20))


def cache_budget_bytes():
    """Current budget in bytes, or None when unlimited."""
    global _cache_budget
    if _cache_budget == "unset":
        env = os.environ.get("TABMAT_TPU_CACHE_BUDGET_MB")
        with _budget_lock:
            if _cache_budget == "unset":
                _cache_budget = int(float(env) * (1 << 20)) if env else None
    return _cache_budget


def cache_spent_bytes() -> int:
    """Bytes currently charged against the budget."""
    return _cache_spent


def _cache_refund(nbytes: int) -> None:
    global _cache_spent
    with _budget_lock:
        _cache_spent = max(0, _cache_spent - nbytes)


def cache_charge(nbytes: int, owner=None) -> bool:
    """Charge a structural device cache against the global budget.

    Returns True when the build may proceed (always, when no budget is
    set).  False tells the caller to take its cache-free route.  The
    charge is refunded when ``owner`` is garbage-collected.
    """
    budget = cache_budget_bytes()
    if budget is None:
        return True
    nbytes = int(nbytes)
    global _cache_spent
    with _budget_lock:
        if _cache_spent + nbytes > budget:
            return False
        _cache_spent += nbytes
    if owner is not None:
        weakref.finalize(owner, _cache_refund, nbytes)
    return True


def default_compilation_cache_dir() -> str:
    """``<checkout>/.jax_cache``: fixed, so every process finds the cache."""
    package_dir = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(package_dir), ".jax_cache")


def initialize() -> None:
    """Apply global JAX configuration for tabmat-tpu (idempotent)."""
    global _initialized
    if _initialized:
        return
    _initialized = True

    if os.environ.get("TABMAT_TPU_NO_X64", "0") != "1":
        jax.config.update("jax_enable_x64", True)

    if os.environ.get("TABMAT_TPU_NO_COMPILATION_CACHE", "0") != "1":
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update(
                "jax_compilation_cache_dir", default_compilation_cache_dir()
            )
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
