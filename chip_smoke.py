"""Run tabmat-tpu's main path once on one GPU and check it against numpy/scipy.

Drives the public entry points a user calls — ``DenseMatrix``,
``SparseMatrix``, ``CategoricalMatrix``, ``SplitMatrix``,
``.standardize(...)``, ``DeviceDesign.from_matrix``, ``irls_step`` and
``fit_glm`` — at the widths ``bench.py`` uses, on inputs made from
``--seed``, and compares every result with a plain numpy/scipy float64
reference.  Each phase prints one JSON line with its largest error beside
its tolerance and its seconds; a phase that fails makes the script exit
non-zero.  The last line is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py                # one GPU, full widths
    python chip_smoke.py --four-cards   # the row-sharded path on four GPUs
    python chip_smoke.py --rehearse     # tiny sizes on the CPU (tests only)

Without ``--rehearse`` the script refuses any platform but a GPU.
"""

import argparse
import importlib.util
import json
import math
import sys
import time

import numpy as np

F32_TOL = float(np.sqrt(np.finfo(np.float32).eps))  # the reference's atol
# cuBLAS/XLA sum in another order than numpy: over 1M rows the expected
# f64 error is about sqrt(n)*eps ~ 1e-13; a leak into f32/TF32 shows at 1e-7
OPS_TOL = 1e-11
# H100 SXM device-memory bandwidth (NVIDIA data sheet), for the byte bound
HBM_BYTES_PER_S = 3.35e12


def _sizes(rehearse: bool) -> dict:
    if rehearse:
        return dict(n=2_000, k=50, ns=800, ks=100, kcat=100, kd=5, kc=20, n4=4_000)
    return dict(
        n=1_000_000, k=50, ns=400_000, ks=100, kcat=10_000, kd=5, kc=1_000,
        n4=4_000_000,
    )


def relerr(got, ref) -> float:
    """Largest absolute error relative to ``max|ref|`` (inf if not finite)."""
    got = np.asarray(getattr(got, "diag", got), dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"shape {got.shape} != reference {ref.shape}")
    if not np.all(np.isfinite(got)):
        return math.inf
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


class Phase:
    """Collects (error, tolerance) checks and prints one JSON line."""

    def __init__(self, name: str):
        self.name = name
        self.checks = {}
        self.extra = {}
        self.t0 = time.perf_counter()

    def check(self, label: str, got, ref, tol: float) -> None:
        self.checks[label] = (relerr(got, ref), tol)

    @staticmethod
    def _ratio(err, tol):
        if tol > 0:
            return err / tol
        return math.inf if err > 0 else 0.0

    def emit(self) -> bool:
        ok = all(err <= tol for err, tol in self.checks.values())
        worst = max(self.checks.items(), key=lambda kv: self._ratio(*kv[1]))
        line = {
            "phase": self.name,
            "ok": ok,
            "max_err": worst[1][0],
            "tol": worst[1][1],
            "worst": worst[0],
            "seconds": time.perf_counter() - self.t0,
            "checks": {k: {"err": e, "tol": t} for k, (e, t) in self.checks.items()},
            **self.extra,
        }
        print(json.dumps(line), flush=True)
        return ok


class CompileClock:
    """Seconds JAX spends compiling (or loading compiled programs)."""

    EVENTS = (
        "/jax/core/compile/backend_compile_duration",
        "/jax/compilation_cache/cache_retrieval_time_sec",
    )

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kwargs):
        if event in self.EVENTS:
            self.total += duration

    def first_call(self, fn):
        """Run ``fn`` once; return (result, compile seconds, wall seconds)."""
        from tabmat_tpu.bench.device import block

        c0, t0 = self.total, time.perf_counter()
        out = block(fn())
        return out, self.total - c0, time.perf_counter() - t0


class Ref:
    """Plain float64 operator ``Xs = A @ diag(mult) + 1 shift^T`` (numpy/scipy).

    ``codes`` marks a one-hot categorical, whose sandwich is its diagonal.
    """

    def __init__(self, A=None, shift=None, mult=None, codes=None, k=None):
        self.A, self.codes = A, codes
        self.k = k if codes is not None else A.shape[1]
        self.shift = np.zeros(self.k) if shift is None else np.asarray(shift)
        self.mult = np.ones(self.k) if mult is None else np.asarray(mult)
        self._gram = {}

    @staticmethod
    def _mask(x, idx):
        if idx is None:
            return x
        out = np.zeros_like(x)
        out[idx] = x[idx]
        return out

    def _At(self, r):
        if self.codes is not None:
            return np.bincount(self.codes, weights=r, minlength=self.k)
        return np.asarray(self.A.T @ r).ravel()

    def matvec(self, v, cols=None):
        v = self._mask(v, cols)
        if self.codes is not None:
            return (self.mult * v)[self.codes] + self.shift @ v
        return np.asarray(self.A @ (self.mult * v)).ravel() + self.shift @ v

    def tmv(self, r, rows=None, cols=None):
        r = self._mask(r, rows)
        out = self.mult * self._At(r) + self.shift * r.sum()
        return out if cols is None else out[cols]

    def gram(self, d):
        """``A.T @ diag(d) @ A``, memoised per weight vector."""
        key = id(d)
        if key not in self._gram:
            A = self.A
            if hasattr(A, "multiply"):
                G = (A.T @ A.multiply(d[:, None]).tocsr()).toarray()
            else:
                G = (A * d[:, None]).T @ A
            self._gram[key] = (d, G)
        return self._gram[key][1]

    def sandwich(self, d, rows=None, cols=None):
        d = self._mask(d, rows)
        if self.codes is not None:
            diag = self.mult**2 * np.bincount(self.codes, weights=d, minlength=self.k)
            return diag if cols is None else diag[cols]
        m, s = self.mult, self.shift
        t = m * self._At(d)
        S = m[:, None] * self.gram(d) * m[None, :]
        S = S + np.outer(t, s) + np.outer(s, t) + np.outer(s, s) * d.sum()
        return S if cols is None else S[np.ix_(cols, cols)]


def _one_hot(codes, k):
    from scipy import sparse as sps

    n = len(codes)
    return sps.csr_matrix((np.ones(n), codes, np.arange(n + 1)), shape=(n, k))


def build_inputs(sz, seed):
    """The matrices of the main path, with their references (host data)."""
    from scipy import sparse as sps

    import tabmat_tpu as tm

    rng = np.random.default_rng(seed)
    n, k = sz["n"], sz["k"]
    X = rng.standard_normal((n, k))
    A_sp = sps.random(sz["ns"], sz["ks"], density=0.01, random_state=rng, format="csc")
    codes = rng.integers(0, sz["kcat"], n)
    Xd = rng.standard_normal((n, sz["kd"]))
    c1 = rng.integers(0, sz["kc"], n)
    c2 = rng.integers(0, sz["kc"], n)
    split = tm.SplitMatrix(
        [
            tm.DenseMatrix(Xd),
            tm.CategoricalMatrix(c1, categories=np.arange(sz["kc"])),
            tm.CategoricalMatrix(c2, categories=np.arange(sz["kc"])),
        ]
    )
    A_split = sps.hstack(
        [sps.csr_matrix(Xd), _one_hot(c1, sz["kc"]), _one_hot(c2, sz["kc"])],
        format="csr",
    )
    std, _, _ = split.standardize(np.full(n, 1.0 / n), True, True)
    mats = {
        "dense": (tm.DenseMatrix(X), Ref(X)),
        "sparse": (tm.SparseMatrix(A_sp), Ref(A_sp.tocsr())),
        "categorical": (
            tm.CategoricalMatrix(codes, categories=np.arange(sz["kcat"])),
            Ref(codes=codes, k=sz["kcat"]),
        ),
        "split": (split, Ref(A_split)),
        "standardized": (std, Ref(A_split, shift=std.shift, mult=std.mult)),
    }
    # the standardized reference reuses the split's Gram matrices
    mats["standardized"][1]._gram = mats["split"][1]._gram
    return dict(mats=mats, X=X, Xd=Xd, c1=c1, c2=c2, A_split=A_split, rng=rng)


def phase_device(rehearse: bool):
    import jax

    import tabmat_tpu  # noqa: F401  (x64 and the compile cache)
    from tabmat_tpu import _native
    from tabmat_tpu.bench.device import card_name_and_power_limit, require_gpu

    t0 = time.perf_counter()
    stamp = require_gpu(rehearse)
    card = card_name_and_power_limit()
    print(card, flush=True)
    line = {
        "phase": "device",
        "ok": True,
        "device": stamp,
        "card": card,
        "jax": jax.__version__,
        "x64": bool(jax.config.jax_enable_x64),
        "compilation_cache_dir": jax.config.jax_compilation_cache_dir,
        "native_helpers_loaded": _native.available(),
        "rehearsal": rehearse,
        "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(line), flush=True)
    return stamp, card


def phase_ops(data, clock, timing) -> bool:
    """sandwich / matvec / transpose_matvec, unrestricted and restricted."""
    import jax.numpy as jnp

    ph = Phase("ops")
    rng = data["rng"]
    for name, (mat, ref) in data["mats"].items():
        n, k = mat.shape
        d = rng.random(n)
        v = rng.standard_normal(k)
        r = rng.standard_normal(n)
        rows = np.sort(rng.choice(n, n // 2, replace=False))
        cols = np.sort(rng.choice(k, max(k // 3, 1), replace=False))
        dj, vj, rj = jnp.asarray(d), jnp.asarray(v), jnp.asarray(r)
        calls = {
            "sandwich": (lambda: mat.sandwich(dj), lambda: ref.sandwich(d)),
            "matvec": (lambda: mat.matvec(vj), lambda: ref.matvec(v)),
            "transpose_matvec": (lambda: mat.transpose_matvec(rj), lambda: ref.tmv(r)),
        }
        for op, (call, want) in calls.items():
            got, compile_s, first_s = clock.first_call(call)
            ph.check(f"{name}.{op}", got, want(), OPS_TOL)
            timing[f"{name}.{op}"] = {"call": call, "compile_s": compile_s,
                                      "first_call_s": first_s}
        ph.check(
            f"{name}.sandwich[rows,cols]",
            mat.sandwich(dj, rows=rows, cols=cols),
            ref.sandwich(d, rows, cols),
            OPS_TOL,
        )
        ph.check(f"{name}.matvec[cols]", mat.matvec(vj, cols=cols),
                 ref.matvec(v, cols), OPS_TOL)
        ph.check(
            f"{name}.transpose_matvec[rows,cols]",
            mat.transpose_matvec(rj, rows=rows, cols=cols),
            ref.tmv(r, rows, cols),
            OPS_TOL,
        )
    return ph.emit()


def phase_from_df(data) -> bool:
    """The mixed design through ``from_df`` equals the hand-built one."""
    missing = [m for m in ("pandas", "narwhals") if importlib.util.find_spec(m) is None]
    if missing:
        # from_df needs both; neither is sure to be installed beside JAX
        print(json.dumps({"phase": "from_df", "ran": False,
                          "reason": f"{' and '.join(missing)} not installed"}),
              flush=True)
        return True
    import jax.numpy as jnp
    import pandas as pd

    import tabmat_tpu as tm

    ph = Phase("from_df")
    Xd, c1, c2 = data["Xd"], data["c1"], data["c2"]
    kc = data["mats"]["split"][0].matrices[1].shape[1]
    df = pd.DataFrame({f"x{j}": Xd[:, j] for j in range(Xd.shape[1])})
    df["c1"] = pd.Categorical(c1, categories=np.arange(kc))
    df["c2"] = pd.Categorical(c2, categories=np.arange(kc))
    X_df = tm.from_df(df)
    split, ref = data["mats"]["split"]
    rng = data["rng"]
    v = rng.standard_normal(split.shape[1])
    r = rng.standard_normal(split.shape[0])
    ph.check("shape", np.asarray(X_df.shape), np.asarray(split.shape), 0.0)
    ph.check("matvec", X_df.matvec(jnp.asarray(v)), ref.matvec(v), OPS_TOL)
    ph.check("transpose_matvec", X_df.transpose_matvec(jnp.asarray(r)), ref.tmv(r),
             OPS_TOL)
    return ph.emit()


def phase_f32(data) -> bool:
    """f32 designs keep f32 accuracy: pinned precision, never TF32."""
    import jax
    import jax.numpy as jnp

    import tabmat_tpu as tm
    from tabmat_tpu.glm import irls_step
    from tabmat_tpu.parallel.design import DeviceDesign

    ph = Phase("f32")
    rng = data["rng"]
    X32 = data["X"].astype(np.float32)
    X32_64 = X32.astype(np.float64)
    n, k = X32.shape
    m32 = tm.DenseMatrix(X32)
    d = rng.random(n).astype(np.float32)
    v = rng.standard_normal(k).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    d64 = d.astype(np.float64)
    ph.check("dense.sandwich", m32.sandwich(jnp.asarray(d)),
             (X32_64 * d64[:, None]).T @ X32_64, F32_TOL)
    ph.check("dense.matvec", m32.matvec(jnp.asarray(v)), X32_64 @ v, F32_TOL)
    ph.check("dense.transpose_matvec", m32.transpose_matvec(jnp.asarray(r)),
             X32_64.T @ r, F32_TOL)

    split, split_ref = data["mats"]["split"]
    w = rng.random(n)
    design32 = DeviceDesign.from_matrix(split).astype_float(jnp.float32)
    H = jax.jit(lambda dd, ww: dd.sandwich(ww))(design32, jnp.asarray(w, jnp.float32))
    ph.check("DeviceDesign.sandwich", H,
             split_ref.sandwich(w.astype(np.float32).astype(np.float64)), F32_TOL)

    # the f32 inner CG of irls_step on the dense Gaussian design, through
    # the explicit-Hessian route (DeviceDesign) and the array route
    X = data["X"]
    y = X @ rng.standard_normal(k) + 0.1 * rng.standard_normal(n)
    b0 = rng.standard_normal(k) * 0.01
    want = b0 + _cg_np(X.T @ X, X.T @ (y - X @ b0), 8)
    args = (jnp.asarray(y), jnp.ones(n), jnp.asarray(b0))
    design = DeviceDesign.from_matrix(data["mats"]["dense"][0])
    for label, Xs in (("irls_step.f32_inner[design]", design),
                      ("irls_step.f32_inner[array]", jnp.asarray(X))):
        got = irls_step(Xs, *args, family="gaussian", n_cg=8)
        ph.check(label, np.asarray(got) - b0, want - b0, F32_TOL)

    # TF32 probe: 1 + 2**-12 is exact in f32 and rounds to 1 in TF32's
    # 10-bit mantissa; at 256 rows the f32 sums stay exact to a few ulp
    probe_tol = 2.0**-14
    x = 1.0 + 2.0**-12
    P = np.full((256, 8), x, np.float32)
    ones_r, ones_c = jnp.ones(256, jnp.float32), jnp.ones(8, jnp.float32)
    mp = tm.DenseMatrix(P)
    ph.check("tf32_probe.matvec", mp.matvec(ones_c), np.full(256, 8 * x), probe_tol)
    ph.check("tf32_probe.transpose_matvec", mp.transpose_matvec(ones_r),
             np.full(8, 256 * x), probe_tol)
    ph.check("tf32_probe.sandwich", mp.sandwich(ones_r),
             np.full((8, 8), 256 * x * x), probe_tol)
    dp = DeviceDesign.from_matrix(tm.DenseMatrix(P.astype(np.float64)))
    dp32 = dp.astype_float(jnp.float32)
    ph.check("tf32_probe.DeviceDesign.sandwich",
             jax.jit(lambda dd, ww: dd.sandwich(ww))(dp32, ones_r),
             np.full((8, 8), 256 * x * x), probe_tol)
    hvp = jax.jit(lambda dd, vv: dd.transpose_matvec(ones_r * dd.matvec(vv)))
    ph.check("tf32_probe.inner_hvp", hvp(dp32, ones_c),
             np.full(8, 256 * 8 * x * x), probe_tol)
    return ph.emit()


def _cg_np(H, g, n_cg):
    """The fixed-iteration CG of ``glm._cg_solve`` in numpy float64."""
    x, r, p, rs = np.zeros_like(g), g.copy(), g.copy(), g @ g
    for _ in range(n_cg):
        Ap = H @ p
        alpha = rs / (p @ Ap) if p @ Ap > 0 else 0.0
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        p = r + (rs_new / rs if rs > 0 else 0.0) * p
        rs = rs_new
    return x


def phase_irls(data, sz, clock, timing) -> bool:
    """irls_step (f64 and f32 inner) and fit_glm against numpy/scipy."""
    import jax.numpy as jnp
    import scipy.linalg
    from scipy import sparse as sps

    import tabmat_tpu as tm
    from tabmat_tpu.glm import fit_glm, irls_step
    from tabmat_tpu.parallel.design import DeviceDesign

    ph = Phase("irls")
    rng = data["rng"]
    n, k = data["X"].shape
    X = data["X"]
    y = X @ rng.standard_normal(k) + 0.1 * rng.standard_normal(n)
    b0 = rng.standard_normal(k) * 0.01
    dense_exact = _cg_np(X.T @ X, X.T @ (y - X @ b0), 8)

    split, split_ref = data["mats"]["split"]
    A = data["A_split"]
    y2 = rng.poisson(1.0, n).astype(np.float64)
    b2 = rng.standard_normal(split.shape[1]) * 0.001
    mu = np.exp(A @ b2)
    mixed_exact = _cg_np(
        (A.T @ A.multiply(mu[:, None]).tocsr()).toarray(), A.T @ (y2 - mu), 8
    )
    cases = {
        "dense_gaussian": (DeviceDesign.from_matrix(data["mats"]["dense"][0]),
                           y, b0, "gaussian", dense_exact),
        "mixed_poisson": (DeviceDesign.from_matrix(split), y2, b2, "poisson",
                          mixed_exact),
    }
    # f64 inner: the same algorithm in the same precision, so only the
    # order of the sums differs (~1e-13); 8 CG steps amplify it by at most
    # the Hessian's condition number (~1e3 for the mixed design)
    tol64 = 1e-8
    # f32 inner is an inexact-Newton direction: the f32 Hessian of the
    # mixed design sums ~1e3 rows per level in a cumsum over 1e6 rows, so
    # its categorical entries carry ~1e-4 relative error, amplified by CG
    tol32 = {"dense_gaussian": F32_TOL, "mixed_poisson": 1e-2}
    for name, (design, yy, bb, fam, exact) in cases.items():
        args = (jnp.asarray(yy), jnp.ones(n), jnp.asarray(bb))
        for prec, tol in (("float64", tol64), ("float32", tol32[name])):
            def step(design=design, args=args, fam=fam, prec=prec):
                return irls_step(design, *args, family=fam, n_cg=8,
                                 inner_precision=prec)

            got, compile_s, first_s = clock.first_call(step)
            ph.check(f"irls_step.{name}.{prec}", np.asarray(got) - bb, exact, tol)
            timing[f"irls_step.{name}.{prec}"] = {
                "call": step, "compile_s": compile_s, "first_call_s": first_s}

    # fit_glm to convergence on the mixed design (second categorical drops
    # its first level so the coefficients are identifiable) against a scipy
    # IRLS that solves each Newton step directly
    kc = sz["kc"]
    fr = tm.SplitMatrix(
        [
            tm.DenseMatrix(data["Xd"]),
            tm.CategoricalMatrix(data["c1"], categories=np.arange(kc)),
            tm.CategoricalMatrix(data["c2"], categories=np.arange(kc),
                                 drop_first=True),
        ]
    )
    k_all = A.shape[1]
    A_fr = sps.hstack([A[:, : k_all - kc], A[:, k_all - kc + 1:]], format="csr")
    beta_ref = np.zeros(A_fr.shape[1])
    for _ in range(50):
        mu = np.exp(A_fr @ beta_ref)
        H = (A_fr.T @ A_fr.multiply(mu[:, None]).tocsr()).toarray()
        delta = scipy.linalg.solve(H, A_fr.T @ (y2 - mu), assume_a="pos")
        beta_ref = beta_ref + delta
        if np.abs(delta).max() < 1e-12:
            break
    beta, n_iter = fit_glm(fr, y2, family="poisson", inner_precision="float64",
                           n_cg=100, tol=1e-9, max_iter=50)
    # both converge to the same MLE: the stopping rule and op rounding
    # amplified by the Fisher information's conditioning stay below 1e-7
    ph.check("fit_glm.mixed_poisson", beta, beta_ref, 1e-7)
    ph.extra["fit_glm_iterations"] = int(n_iter)
    return ph.emit()


def phase_timing(timing, stamp, card, dense_shape) -> None:
    """For information only: compile seconds, steady medians, peak memory."""
    import jax

    from tabmat_tpu.bench.device import median_seconds

    t0 = time.perf_counter()
    rows = {}
    for label, rec in timing.items():
        rows[label] = {
            "compile_s": rec["compile_s"],
            "first_call_s": rec["first_call_s"],
            "median_ms": median_seconds(rec["call"], reps=10) * 1e3,
        }
    stats = jax.devices()[0].memory_stats() or {}
    line = {
        "phase": "timing",
        "ok": True,
        "device": stamp,
        "card": card,
        "ops": rows,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "seconds": time.perf_counter() - t0,
    }
    n, k = dense_shape
    line["dense.sandwich_byte_bound_ms"] = n * k * 8 / HBM_BYTES_PER_S * 1e3
    line["byte_bound_source"] = "H100 SXM 3.35 TB/s (data sheet), read of X once"
    print(json.dumps(line), flush=True)


def run_one_card(args) -> int:
    stamp, card = phase_device(args.rehearse)
    sz = _sizes(args.rehearse)
    clock = CompileClock()
    timing = {}
    data = build_inputs(sz, args.seed)
    ok = phase_ops(data, clock, timing)
    ok &= phase_from_df(data)
    ok &= phase_f32(data)
    ok &= phase_irls(data, sz, clock, timing)
    phase_timing(timing, stamp, card, data["X"].shape)
    if not ok:
        print("a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": stamp}), flush=True)
    return 0


def run_four_cards(args) -> int:
    """DeviceDesign.shard over four devices, against a one-device replay."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import tabmat_tpu as tm
    from tabmat_tpu.bench.device import card_name_and_power_limit, require_gpu
    from tabmat_tpu.glm import irls_step
    from tabmat_tpu.ops import dense_ops
    from tabmat_tpu.ops.segments import build_plan
    from tabmat_tpu.parallel import (
        MixedDesign,
        build_mixed_design,
        make_mesh,
        mixed_irls_step,
    )
    from tabmat_tpu.parallel.design import DeviceDesign
    from tabmat_tpu.parallel.shard_ops import (
        place_row_sharded,
        sharded_sandwich,
        sharded_segment_sum,
        sharded_transpose_matvec,
    )

    stamp = require_gpu(args.rehearse)
    if stamp["count"] < 4:
        raise SystemExit(f"--four-cards needs 4 devices, JAX sees {stamp['count']}")
    card = card_name_and_power_limit()
    print(card, flush=True)
    sz = _sizes(args.rehearse)
    # six dense columns, not five: the 2x2 layout splits them over 'mp'
    n, kd, kc = sz["n4"], 6, sz["kc"]
    rng = np.random.default_rng(args.seed)
    ph = Phase("four_cards")
    ph.extra.update(device=stamp, card=card, rows=n)

    split = tm.SplitMatrix(
        [
            tm.DenseMatrix(rng.standard_normal((n, kd))),
            tm.CategoricalMatrix(rng.integers(0, kc, n), categories=np.arange(kc)),
            tm.CategoricalMatrix(rng.integers(0, kc, n), categories=np.arange(kc)),
        ]
    )
    design = DeviceDesign.from_matrix(split)
    y = jnp.asarray(rng.poisson(1.0, n).astype(np.float64))
    w = jnp.ones(n)
    b0 = jnp.asarray(rng.standard_normal(split.shape[1]) * 0.001)
    ref = np.asarray(irls_step(design, y, w, b0, family="poisson", n_cg=8,
                               inner_precision="float64"))
    # the all-reduce sums the per-shard partials in another order (~1e-13),
    # amplified by 8 CG steps by at most the Hessian's condition number
    tol_step = 1e-8
    devices = jax.devices()[:4]
    for label, mp, dense_cols in (("rows_over_4", 1, None),
                                  ("dp2_x_mp2", 2, "mp")):
        mesh = make_mesh(4, mp=mp)
        sharded = design.shard(mesh, rows="dp", dense_cols=dense_cols)
        X_sh = sharded.blocks[0].arrays["X"]
        held = {s.device for s in X_sh.addressable_shards}
        ph.check(f"{label}.distinct_devices", np.float64(len(held)), 4.0, 0.0)

        def rows(x, mesh=mesh):
            return jax.device_put(x, NamedSharding(mesh, P("dp")))

        with mesh:
            got = irls_step(sharded, rows(y), rows(w),
                            jax.device_put(b0, NamedSharding(mesh, P())),
                            family="poisson", n_cg=8, inner_precision="float64")
            got.block_until_ready()
        ph.check(f"{label}.irls_step", np.asarray(got) - np.asarray(b0),
                 ref - np.asarray(b0), tol_step)
        stats = [dev.memory_stats() for dev in devices]
        if all(stats):
            # each device must hold at least its row shard of the dense block
            shard_bytes = X_sh.nbytes // 4
            in_use = [s["bytes_in_use"] for s in stats]
            ph.extra[f"{label}.bytes_in_use"] = in_use
            ph.check(f"{label}.every_device_holds_its_shard",
                     np.float64(min(in_use) >= shard_bytes), 1.0, 0.0)

    # the explicit GSPMD mixed-design step of parallel.distributed
    dz = build_mixed_design(n, kd, 10, kc, seed=args.seed + 1)
    y3 = jnp.asarray(rng.poisson(2.0, n).astype(np.float64))
    beta3 = jnp.zeros(kd + 10 + kc)
    ref3 = np.asarray(mixed_irls_step(dz, y3, w, beta3, family="poisson", n_cg=6))
    mesh = make_mesh(4, mp=1)

    def put(x, *spec):
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    dz_sh = MixedDesign(
        dense=put(dz.dense, "dp", None),
        sp_csr_data=put(dz.sp_csr_data), sp_csr_cols=put(dz.sp_csr_cols),
        sp_csr_bounds=put(dz.sp_csr_bounds), sp_csc_data=put(dz.sp_csc_data),
        sp_csc_rows=put(dz.sp_csc_rows), sp_csc_bounds=put(dz.sp_csc_bounds),
        cat_codes=put(dz.cat_codes, "dp"), cat_perm=put(dz.cat_perm, "dp"),
        cat_bounds=put(dz.cat_bounds),
    )
    with mesh:
        got3 = mixed_irls_step(dz_sh, put(y3, "dp"), put(w, "dp"), put(beta3),
                               family="poisson", n_cg=6)
        got3.block_until_ready()
    ph.check("mixed_irls_step", got3, ref3, tol_step)

    # the explicit shard_map kernels: per-shard partials + one psum
    Xn = rng.standard_normal((n, kd))
    d = rng.random(n)
    codes = rng.integers(0, kc, n).astype(np.int32)
    X_s, d_s, c_s = place_row_sharded(mesh, jnp.asarray(Xn), jnp.asarray(d),
                                      jnp.asarray(codes))
    Xj, dj = jnp.asarray(Xn), jnp.asarray(d)
    ph.check("shard_map.sandwich", sharded_sandwich(X_s, d_s, mesh),
             dense_ops.sandwich(Xj, dj), OPS_TOL)
    ph.check("shard_map.transpose_matvec", sharded_transpose_matvec(X_s, d_s, mesh),
             dense_ops.transpose_matvec(Xj, dj), OPS_TOL)
    ph.check("shard_map.segment_sum", sharded_segment_sum(d_s, c_s, kc, mesh),
             build_plan(codes, kc).sum(dj), OPS_TOL)
    if not ph.emit():
        print("the four-card phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": stamp}), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rehearse", action="store_true",
                        help="tiny sizes; allows the CPU (tests only)")
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-device sharded path")
    args = parser.parse_args(argv)
    import tabmat_tpu  # noqa: F401  (x64 and the compile cache, before any work)

    if args.four_cards:
        return run_four_cards(args)
    return run_one_card(args)


if __name__ == "__main__":
    sys.exit(main())
