"""Peak host-memory tracking for benchmarks (tracemalloc polling thread).

Same protocol as the reference (``benchmark/memory_tools.py:6-48``): a
daemon thread snapshots traced memory every millisecond and records the
peak.  Device (HBM) memory is reported separately via
``jax.local_devices()[0].memory_stats()`` when the backend exposes it.
"""

import threading
import time
import tracemalloc


class MemoryPoller:
    """Poll tracemalloc in a background thread; use as a context manager."""

    def __init__(self, interval_s: float = 0.001):
        self.interval_s = interval_s
        self.max_memory = 0
        self._stop = False

    def _poll(self):
        while not self._stop:
            self.max_memory = max(self.max_memory, tracemalloc.get_traced_memory()[0])
            time.sleep(self.interval_s)

    def __enter__(self):
        tracemalloc.start()
        self.initial = tracemalloc.get_traced_memory()[0]
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop = True
        self._thread.join()
        self.max_memory = max(self.max_memory, tracemalloc.get_traced_memory()[0])
        tracemalloc.stop()
        return False


def track_peak_mem(fn, *args, **kwargs):
    """Run ``fn`` and return its peak traced host memory in bytes."""
    with MemoryPoller() as poller:
        fn(*args, **kwargs)
    return poller.max_memory - poller.initial


def device_memory_stats():
    """Memory stats of the default device (None where unsupported)."""
    import jax

    try:
        return jax.local_devices()[0].memory_stats()
    except Exception:
        return None


def hbm_bytes_in_use():
    """Device bytes held by live framework arrays (or runtime stats).

    Prefers the runtime's ``memory_stats()`` when the backend exposes it;
    where it does not (the CPU), the fallback sums ``jax.live_arrays()`` —
    every structural cache this library builds is a live ``jax.Array``, so
    this counts the library's device footprint, excluding only transient
    scratch inside a single XLA program.
    """
    import jax

    stats = device_memory_stats()
    if stats and "bytes_in_use" in stats:
        return stats["bytes_in_use"]
    try:
        return sum(a.nbytes for a in jax.live_arrays())
    except Exception:
        return None
