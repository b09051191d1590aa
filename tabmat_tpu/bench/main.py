"""Benchmark CLI: ops × matrix zoo, with numpy/scipy baselines.

Same shape as the reference CLI (``benchmark/main.py:58-383``): choose
matrices and operations, optionally track peak host memory, write CSV.

Device timing: each op is called through the public API with a
device-resident operand; after a warm-up call (which compiles), the median
of ``n_iterations`` calls is taken, each ending in ``block_until_ready``.
Every row carries the device stamp (platform, kind, count) and the card's
name and power limit.  A run refuses a platform that is not a GPU unless
``--rehearse`` is given (tiny CPU runs for the tests).

Example::

    python -m tabmat_tpu.bench.main --matrix_name dense,sparse --scale 0.01
"""

import json
import time

import click
import numpy as np

from .device import block, card_name_and_power_limit, median_seconds, require_gpu
from .generate import get_all_benchmark_matrices
from .memory import hbm_bytes_in_use, track_peak_mem

OPS = ("matvec", "transpose-matvec", "sandwich")


def _get_op(mat, op):
    """A zero-argument call of ``op`` on ``mat`` with a device operand."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    n, k = mat.shape
    if op == "matvec":
        x = jnp.asarray(rng.standard_normal(k))
        return lambda: mat.matvec(x)
    if op == "transpose-matvec":
        x = jnp.asarray(rng.standard_normal(n))
        return lambda: mat.transpose_matvec(x)
    if op == "sandwich":
        d = jnp.asarray(rng.random(n))
        return lambda: mat.sandwich(d)
    raise ValueError(op)


def _get_baseline_fn(mat, op):
    """numpy/scipy equivalent on the host (the reference's competitors)."""
    from scipy import sparse as sps

    arr = None
    try:
        arr = mat.unpack()
    except Exception:
        pass
    if not isinstance(arr, np.ndarray) and not sps.issparse(arr):
        if hasattr(mat, "tocsr"):
            # categorical: scipy one-hot CSR (never densify 1M×100k)
            arr = mat.tocsr()
        elif hasattr(mat, "matrices"):
            # split designs: hstack per-block CSRs
            arr = sps.hstack(
                [
                    m.tocsr()
                    if hasattr(m, "tocsr")
                    else sps.csr_matrix(np.asarray(m.toarray()))
                    for m in mat.matrices
                ],
                format="csr",
            )
        else:
            arr = sps.csr_matrix(mat.toarray())
    if isinstance(arr, (np.ndarray,)) and hasattr(arr, "device"):
        arr = np.asarray(arr)

    rng = np.random.default_rng(0)
    if op == "matvec":
        v = rng.standard_normal(mat.shape[1])
        return lambda: arr @ v
    if op == "transpose-matvec":
        v = rng.standard_normal(mat.shape[0])
        return lambda: arr.T @ v
    if op == "sandwich":
        d = rng.random(mat.shape[0])
        if sps.issparse(arr):
            return lambda: (arr.T @ arr.multiply(d[:, None]))
        return lambda: (arr * d[:, None]).T @ arr
    raise ValueError(op)


def run_one_benchmark_set(
    mat, name, ops, n_iterations, include_baseline, bench_memory, stamp=None
):
    rows = []
    for op in ops:
        call = _get_op(mat, op)
        hbm_before = hbm_bytes_in_use()
        best = median_seconds(call, reps=n_iterations)
        hbm_after = hbm_bytes_in_use()
        row = {"matrix": name, "operation": op, "library": "tabmat_tpu", "time_s": best}
        if stamp is not None:
            row.update(stamp)
        if hbm_before is not None and hbm_after is not None:
            # device bytes of the structural caches this op built (sparse
            # dense mirrors, segment plans) as the delta of live bytes
            row["hbm_cache_bytes"] = hbm_after - hbm_before
            row["hbm_total_bytes"] = hbm_after
        if bench_memory:
            row["peak_mem_bytes"] = track_peak_mem(lambda: block(call()))
        rows.append(row)

        if include_baseline:
            bfn = _get_baseline_fn(mat, op)
            bfn()  # warm
            bbest = float("inf")
            for _ in range(max(n_iterations // 10, 3)):
                t0 = time.perf_counter()
                bfn()
                bbest = min(bbest, time.perf_counter() - t0)
            rows.append(
                {
                    "matrix": name,
                    "operation": op,
                    "library": "numpy/scipy",
                    "time_s": bbest,
                }
            )
    return rows


@click.command()
@click.option("--matrix_name", default=None, help="comma-separated design names")
@click.option("--ops", default=None, help="comma-separated op subset (default: all)")
@click.option("--n_iterations", default=20, type=int)
@click.option("--include_baseline", is_flag=True)
@click.option("--bench_memory", is_flag=True)
@click.option("--standardized", is_flag=True)
@click.option("--scale", default=1.0, type=float, help="row-count scale factor")
@click.option("--output", default=None, help="CSV output path")
@click.option(
    "--profile_dir",
    default=None,
    help="capture a jax.profiler trace of the benchmark into this directory",
)
@click.option("--rehearse", is_flag=True, help="allow a CPU run (tests only)")
def run_all_benchmarks(
    matrix_name, ops, n_iterations, include_baseline, bench_memory, standardized,
    scale, output, profile_dir, rehearse
):
    """Run the benchmark suite and print/save results."""
    stamp = {
        f"device_{key}": value for key, value in require_gpu(rehearse).items()
    }
    stamp["card"] = card_name_and_power_limit()
    ops = tuple(ops.split(",")) if ops else OPS
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)
    designs = get_all_benchmark_matrices(scale=scale)
    if matrix_name:
        wanted = matrix_name.split(",")
        designs = {k: v for k, v in designs.items() if k in wanted}

    all_rows = []
    for name, thunk in designs.items():
        mat = thunk()
        if standardized:
            import tabmat_tpu as tm

            mat = tm.StandardizedMatrix(mat, np.zeros(mat.shape[1]))
        rows = run_one_benchmark_set(
            mat, name, ops, n_iterations, include_baseline, bench_memory, stamp
        )
        all_rows.extend(rows)
        for r in rows:
            click.echo(json.dumps(r))

    if profile_dir:
        import jax

        jax.profiler.stop_trace()
        click.echo(f"profiler trace in {profile_dir}")

    if output:
        import csv

        keys = sorted({k for r in all_rows for k in r})
        with open(output, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(all_rows)
        click.echo(f"wrote {output}")


if __name__ == "__main__":
    run_all_benchmarks()
