"""Device stamp and steady-state timing shared by the benchmarks.

Every number a benchmark prints names the device it ran on: JAX's
platform, device kind and device count, plus the card's name and power
limit as ``nvidia-smi`` reports them (a card below its full power limit
runs slower under load).  A measurement run refuses a platform that is not
a GPU; only an explicit rehearsal (tiny sizes, for the tests) may run on
the CPU.
"""

import statistics
import subprocess
import time

NVIDIA_SMI_QUERY = [
    "nvidia-smi",
    "--query-gpu=name,power.limit",
    "--format=csv,noheader",
]


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power-limit line(s), read by a child process.

    The child never touches JAX, so it cannot contend for the card.
    """
    try:
        out = subprocess.run(
            NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=30
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    if out.returncode != 0:
        return f"nvidia-smi failed (exit {out.returncode})"
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())


def device_stamp() -> dict:
    """Platform, device kind and device count as JAX reports them."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def require_gpu(rehearse: bool) -> dict:
    """The device stamp; exits non-zero unless JAX runs on a GPU.

    ``rehearse=True`` is the one exception: a tiny-size run on the CPU
    that checks control flow, never a measurement.
    """
    stamp = device_stamp()
    if stamp["platform"] != "gpu" and not rehearse:
        raise SystemExit(
            f"no GPU: JAX runs on {stamp['platform']!r} "
            f"({stamp['kind']}); pass --rehearse for a CPU rehearsal"
        )
    return stamp


def block(result):
    """Wait for every device array in ``result`` (nested, or a diagonal)."""
    if isinstance(result, (list, tuple)):
        for r in result:
            block(r)
    elif hasattr(result, "block_until_ready"):
        result.block_until_ready()
    elif hasattr(result, "diag"):
        block(result.diag)
    return result


def median_seconds(fn, reps: int = 10, warmup: int = 1) -> float:
    """Median wall seconds of ``fn()`` after ``warmup`` calls.

    Each call ends in ``block_until_ready`` on its result, so the time
    covers the work on the device and not only its dispatch.
    """
    for _ in range(warmup):
        block(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)
