"""Core-op benchmark: GLM core ops (sandwich / matvec / transpose-matvec).

Measures tabmat-tpu on the GPU against CPU numpy/scipy equivalents — the
same competitors the reference benchmarks against (the reference publishes
no absolute numbers, see BASELINE.md).

Configs follow BASELINE.json: dense 1M×50 fp64, categorical 1M rows × 10k
categories, sparse 400k×100 @1% density, plus two IRLS steps (the dense
design, and 1M × (5 dense + 1k cat + 1k cat) Poisson).

Timing: each op is called through the public API with device-resident
inputs; after one warm-up call (which compiles), the median of 10 calls
is taken, each ending in ``block_until_ready``.  Host baselines take the
median of 3 calls after a warm-up.

Prints ONE JSON line:
  {"metric": ..., "value": <geomean ms over ops>, "unit": "ms",
   "vs_baseline": <geomean speedup vs numpy/scipy on this host>,
   "device": {...}, "card": "<nvidia-smi name, power limit>", ...}

Run ``python bench.py`` on a GPU; ``--rehearse --scale 0.002`` runs a tiny
version on the CPU (control flow only, no measurement).
"""

import argparse
import json
import sys
import time

import numpy as np


def _note(t0, msg):
    print(f"[bench +{time.time() - t0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _host_seconds(fn, reps=3):
    fn()  # warm caches / BLAS threads
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rehearse", action="store_true",
                        help="allow a CPU run at tiny scale (tests only)")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="row-count scale factor")
    args = parser.parse_args(argv)

    import jax.numpy as jnp
    from scipy import sparse as sps

    import tabmat_tpu as tm
    from tabmat_tpu.bench.device import (
        card_name_and_power_limit,
        median_seconds,
        require_gpu,
    )
    from tabmat_tpu.glm import irls_step
    from tabmat_tpu.parallel.design import DeviceDesign

    stamp = require_gpu(args.rehearse)
    card = card_name_and_power_limit()
    scale = args.scale
    t0 = time.time()
    rng = np.random.default_rng(0)
    results = {}  # name -> (ours_sec, baseline_sec)

    def dev(a):
        return jnp.asarray(a).block_until_ready()

    # ---------------- dense 1M x 50 fp64 ----------------
    n, k = max(int(1_000_000 * scale), 512), 50
    X_np = rng.standard_normal((n, k))
    dm = tm.DenseMatrix(X_np)
    d0_np, v0_np, r0_np = rng.random(n), rng.standard_normal(k), rng.standard_normal(n)
    d0, v0, r0 = dev(d0_np), dev(v0_np), dev(r0_np)
    results["dense_sandwich"] = (
        median_seconds(lambda: dm.sandwich(d0)),
        _host_seconds(lambda: (X_np * d0_np[:, None]).T @ X_np),
    )
    results["dense_matvec"] = (
        median_seconds(lambda: dm.matvec(v0)),
        _host_seconds(lambda: X_np @ v0_np),
    )
    results["dense_tmv"] = (
        median_seconds(lambda: dm.transpose_matvec(r0)),
        _host_seconds(lambda: X_np.T @ r0_np),
    )
    S = np.asarray(dm.sandwich(d0))
    S_ref = (X_np * d0_np[:, None]).T @ X_np
    dense_relerr = float(np.abs(S - S_ref).max() / np.abs(S_ref).max())
    _note(t0, "dense done")

    # ---------------- categorical 1M x 10k ----------------
    ncat = max(int(10_000 * scale), 16)
    codes = rng.integers(0, ncat, n).astype(np.int32)
    cm = tm.CategoricalMatrix(codes, categories=np.arange(ncat))
    C_csr = sps.csr_matrix((np.ones(n), codes, np.arange(n + 1)), shape=(n, ncat))
    C_csc = C_csr.tocsc()
    vc0_np = rng.standard_normal(ncat)
    vc0 = dev(vc0_np)
    results["cat_sandwich"] = (
        median_seconds(lambda: cm.sandwich(d0)),
        _host_seconds(lambda: (C_csr.multiply(d0_np[:, None]).T @ C_csr).diagonal()),
    )
    results["cat_matvec"] = (
        median_seconds(lambda: cm.matvec(vc0)),
        _host_seconds(lambda: C_csr @ vc0_np),
    )
    results["cat_tmv"] = (
        median_seconds(lambda: cm.transpose_matvec(r0)),
        _host_seconds(lambda: C_csc.T @ r0_np),
    )
    _note(t0, "categorical done")

    # ---------------- sparse 400k x 100 @ 1% ----------------
    ns, ks = max(int(400_000 * scale), 512), 100
    S_sp = sps.random(ns, ks, density=0.01, random_state=0, format="csc")
    S_csr = S_sp.tocsr()
    sm = tm.SparseMatrix(S_sp)
    ds0_np, vs0_np, rs0_np = rng.random(ns), rng.standard_normal(ks), rng.standard_normal(ns)
    ds0, vs0, rs0 = dev(ds0_np), dev(vs0_np), dev(rs0_np)
    results["sparse_sandwich"] = (
        median_seconds(lambda: sm.sandwich(ds0)),
        _host_seconds(lambda: (S_sp.T @ S_sp.multiply(ds0_np[:, None])).toarray()),
    )
    results["sparse_matvec"] = (
        median_seconds(lambda: sm.matvec(vs0)),
        _host_seconds(lambda: S_csr @ vs0_np),
    )
    results["sparse_tmv"] = (
        median_seconds(lambda: sm.transpose_matvec(rs0)),
        _host_seconds(lambda: S_sp.T @ rs0_np),
    )
    _note(t0, "sparse done")

    # ---------------- GLM IRLS step on the dense design ----------------
    dense_design = DeviceDesign.from_matrix(dm)
    y_np = X_np @ rng.standard_normal(k) + 0.1 * rng.standard_normal(n)
    y_dev, w_dev = dev(y_np), dev(np.ones(n))
    b0 = dev(rng.standard_normal(k) * 0.01)
    X32_np = X_np.astype(np.float32)

    def glm_step_np(beta):
        # the same algorithm in numpy: f64 gradient, f32 Hessian and CG
        # (irls_step's default inner_precision='float32')
        g = (X_np.T @ (y_np - X_np @ beta)).astype(np.float32)
        H = X32_np.T @ X32_np
        x, r, p, rs = np.zeros_like(g), g.copy(), g.copy(), g @ g
        for _ in range(8):
            Ap = H @ p
            alpha = rs / max(p @ Ap, np.float32(1e-30))
            x += alpha * p
            r -= alpha * Ap
            rs_new = r @ r
            p = r + (rs_new / max(rs, np.float32(1e-30))) * p
            rs = rs_new
        return beta + x.astype(np.float64)

    b0_np = np.asarray(b0)
    results["glm_irls_step"] = (
        median_seconds(
            lambda: irls_step(dense_design, y_dev, w_dev, b0, family="gaussian", n_cg=8)
        ),
        _host_seconds(lambda: glm_step_np(b0_np)),
    )
    _note(t0, "glm_irls_step done")

    # ------- GLM IRLS step on a mixed split design -------
    kd, kc1, kc2 = 5, max(int(1000 * scale), 8), max(int(1000 * scale), 8)
    split = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, kd))),
            tm.CategoricalMatrix(
                rng.integers(0, kc1, n).astype(np.int32), categories=np.arange(kc1)
            ),
            tm.CategoricalMatrix(
                rng.integers(0, kc2, n).astype(np.int32), categories=np.arange(kc2)
            ),
        ]
    )
    design = DeviceDesign.from_matrix(split)
    km = split.shape[1]
    y2_np = rng.poisson(1.0, n).astype(np.float64)
    y2, w2 = dev(y2_np), dev(np.ones(n))
    b20 = dev(rng.standard_normal(km) * 0.001)
    X_csr64 = sps.hstack(
        [m.tocsr() if hasattr(m, "tocsr") else sps.csr_matrix(m.toarray())
         for m in split.matrices],
        format="csr",
    )

    def split_step_np(beta):
        # the same algorithm over a scipy CSR, in f64
        mu = np.exp(X_csr64 @ beta)
        g = X_csr64.T @ (y2_np - mu)
        x, r, p, rs = np.zeros_like(g), g.copy(), g.copy(), g @ g
        for _ in range(8):
            Ap = X_csr64.T @ (mu * (X_csr64 @ p))
            alpha = rs / max(p @ Ap, 1e-300)
            x += alpha * p
            r -= alpha * Ap
            rs_new = r @ r
            p = r + (rs_new / max(rs, 1e-300)) * p
            rs = rs_new
        return beta + x

    b20_np = np.asarray(b20)
    results["glm_irls_step_mixed"] = (
        median_seconds(
            lambda: irls_step(design, y2, w2, b20, family="poisson", n_cg=8)
        ),
        _host_seconds(lambda: split_step_np(b20_np)),
    )
    _note(t0, "glm_irls_step_mixed done")

    ours = np.array([v[0] for v in results.values()])
    base = np.array([v[1] for v in results.values()])
    payload = {
        "metric": "glm_core_ops_geomean (dense 1Mx50 fp64, cat 1Mx10k, "
        "sparse 400kx100; sandwich+matvec+tmv+irls_step; median of 10 "
        "calls after warm-up)",
        "value": float(np.exp(np.mean(np.log(ours))) * 1e3),
        "unit": "ms",
        "vs_baseline": float(np.exp(np.mean(np.log(base / ours)))),
        "detail": {
            name: {"tabmat_tpu_ms": o * 1e3, "cpu_baseline_ms": b * 1e3}
            for name, (o, b) in results.items()
        },
        "dense_sandwich_f64_relerr": dense_relerr,
        "device": stamp,
        "card": card,
        "rehearsal": args.rehearse,
    }
    print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
