"""A GLM solver built on the tabmat-tpu kernels.

The reference library exists to serve a GLM solver (glum; reference
``README.md:46``).  tabmat-tpu ships the solver layer itself as its
flagship "model": iteratively reweighted least squares with a
conjugate-gradient inner solve — every FLOP is a sandwich-structured
matvec, so the whole training step jits into a single XLA program with no
host round-trips and no factorization.

Functional core (jittable, shardable over a row mesh):
  - ``irls_step(X, y, weights, beta, family=...)`` — one Newton step
  - ``fit_glm(...)`` — host loop with convergence check

Families: gaussian, poisson, logistic, gamma (canonical links).
"""

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .ops import dense_ops

FAMILIES = (
    "gaussian",
    "poisson",
    "logistic",
    "gamma",
    "inverse_gaussian",
    "tweedie",
)

# glum-compatible spellings (glum: Normal/Binomial/InverseGaussian etc.)
_FAMILY_ALIASES = {
    "normal": "gaussian",
    "binomial": "logistic",
    "bernoulli": "logistic",
    "inverse.gaussian": "inverse_gaussian",
}


def _parse_family(family: str):
    """'tweedie(p)' → ('tweedie', p); other names pass through."""
    family = _FAMILY_ALIASES.get(family, family)
    if family.startswith("tweedie"):
        if "(" in family:
            power = float(family[family.index("(") + 1 : family.rindex(")")])
        else:
            power = 1.5
        if not 1.0 < power < 2.0:
            raise ValueError(
                f"tweedie power must be in (1, 2), got {power}"
            )
        return "tweedie", power
    return family, None


def _family_terms(family: str, eta: jax.Array, y: jax.Array):
    """Return (mu, irls_weight, working_residual) for the canonical link.

    For canonical links the IRLS weight is Var(mu) = dmu/deta and the
    Newton step solves  (Xᵀ W X) δ = Xᵀ (y - mu).
    """
    family = _FAMILY_ALIASES.get(family, family)
    if family == "gaussian":
        mu = eta
        w = jnp.ones_like(eta)
    elif family == "poisson":
        mu = jnp.exp(eta)
        w = mu
    elif family == "logistic":
        mu = jax.nn.sigmoid(eta)
        w = mu * (1 - mu)
    elif family == "gamma":
        # log link (common practical choice): w = mu²/V(mu) = 1 and the
        # score is Xᵀ((y - mu)/mu) — NOT the Poisson residual y - mu
        mu = jnp.exp(eta)
        w = jnp.ones_like(eta)
        return mu, w, (y - mu) / mu
    elif family == "inverse_gaussian":
        # V(mu) = mu³ under the log link: Fisher weight mu^{-1},
        # score Xᵀ((y - mu)/mu²)
        mu = jnp.exp(eta)
        w = 1.0 / mu
        return mu, w, (y - mu) / (mu * mu)
    elif family.startswith("tweedie"):
        # compound Poisson-gamma with V(mu) = mu^p under the log link:
        # Fisher weight mu^{2-p}, score Xᵀ((y - mu)·mu^{1-p})
        _, power = _parse_family(family)
        mu = jnp.exp(eta)
        w = mu ** (2.0 - power)
        return mu, w, (y - mu) * mu ** (1.0 - power)
    else:
        raise ValueError(f"Unknown family {family!r}; options: {FAMILIES}")
    return mu, w, y - mu


def _make_mv_tmv(X):
    """Matvec/transpose-matvec closures for an array or DeviceDesign."""
    if isinstance(X, jax.Array):
        return (
            lambda v: dense_ops.matvec(X, v),
            lambda r: dense_ops.transpose_matvec(X, r),
        )
    return (lambda v: X @ v), (lambda r: X.T @ r)


def _cg_solve(matvec: Callable, b: jax.Array, n_iter: int) -> jax.Array:
    """Fixed-iteration conjugate gradient (jittable, lax.fori_loop).

    Convergence-safe: once the residual has collapsed (or ``pᵀAp`` flushes
    to zero on FTZ hardware), the step sizes are forced to 0 instead of
    dividing by a flushed denominator — running past convergence would
    otherwise overflow into inf−inf = NaN.
    """
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, dtype=b.dtype)

    def body(_, state):
        x, r, p, rs = state
        Ap = matvec(p)
        denom = dense_ops.matmul(p, Ap)
        live = denom > tiny
        alpha = jnp.where(live, rs / jnp.where(live, denom, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = dense_ops.matmul(r, r)
        beta = jnp.where(
            rs > tiny, rs_new / jnp.where(rs > tiny, rs, 1.0), 0.0
        )
        p = r + beta * p
        return (x, r, p, rs_new)

    x0 = jnp.zeros_like(b)
    state = (x0, b, b, dense_ops.matmul(b, b))
    x, *_ = jax.lax.fori_loop(0, n_iter, body, state)
    return x


@partial(jax.jit, static_argnames=("family", "n_cg", "l2", "inner_precision"))
def irls_step(
    X: jax.Array,
    y: jax.Array,
    sample_weight: jax.Array,
    beta: jax.Array,
    family: str = "gaussian",
    n_cg: int = 16,
    l2: float = 0.0,
    inner_precision: str = "float32",
    penalty_scale=None,
    offset=None,
) -> jax.Array:
    """One IRLS Newton step with a matrix-free CG inner solve.

    The Hessian-vector product is two sandwich-structured matvecs —
    ``Hv = Xᵀ (w ⊙ (X v)) + l2·v`` — which, under a row-sharded mesh,
    reduce with a single all-reduce per matvec.  Designs with an explicit
    sandwich build the (k, k) Hessian once and run CG on it.

    The linear predictor and gradient are evaluated in the operand dtype;
    by default the *inner* CG iteration runs in float32 — an inexact-Newton
    direction, which IRLS absorbs (same fixed point, occasionally one extra
    outer iteration).  Every float32 contraction is pinned to full
    precision (never TF32).  Pass ``inner_precision='float64'`` for a fully
    f64 step.
    """
    mv, tmv = _make_mv_tmv(X)

    eta = mv(beta)
    if offset is not None:
        eta = eta + offset
    mu, w_irls, resid = _family_terms(family, eta, y)
    w = sample_weight * w_irls
    # penalty_scale (e.g. 0 on the intercept) keeps chosen coords unpenalized
    ps = jnp.ones_like(beta) if penalty_scale is None else penalty_scale
    grad = tmv(sample_weight * resid) - l2 * ps * beta

    if getattr(X, "supports_sandwich", False):
        # explicit-Hessian path: ONE sandwich per step (the expensive
        # segment reductions run once), then CG on the small (k, k) matrix.
        # With inner_precision='float32' the direction's Hessian is built in
        # f32 (halved gather traffic) — inexact Newton, f64 gradient keeps
        # the fixed point exact.
        if inner_precision == "float32" and jnp.dtype(X.dtype) == jnp.float64:
            X32 = X.astype_float(jnp.float32)
            H = X32.sandwich(w.astype(jnp.float32))
            if l2:
                H = H + jnp.float32(l2) * jnp.diag(ps.astype(jnp.float32))
            delta = _cg_solve(
                lambda v: dense_ops.matmul(H, v), grad.astype(jnp.float32), n_cg
            )
            return beta + delta.astype(beta.dtype)
        H = X.sandwich(w)
        if l2:
            H = H + l2 * jnp.diag(ps)
        delta = _cg_solve(lambda v: dense_ops.matmul(H, v), grad, n_cg)
        return beta + delta

    use_f32_inner = inner_precision == "float32" and jnp.dtype(
        getattr(X, "dtype", jnp.float64)
    ) == jnp.float64
    if use_f32_inner and isinstance(X, jax.Array):
        X32 = X.astype(jnp.float32)
        w32 = w.astype(jnp.float32)

        ps32 = ps.astype(jnp.float32)

        def hvp(v):
            return (
                dense_ops.transpose_matvec(X32, w32 * dense_ops.matvec(X32, v))
                + jnp.float32(l2) * ps32 * v
            )

        delta = _cg_solve(hvp, grad.astype(jnp.float32), n_cg)
        return beta + delta.astype(beta.dtype)
    if use_f32_inner and hasattr(X, "astype_float"):
        X32 = X.astype_float(jnp.float32)
        w32 = w.astype(jnp.float32)

        ps32 = ps.astype(jnp.float32)

        def hvp(v):
            return (
                X32.transpose_matvec(w32 * X32.matvec(v))
                + jnp.float32(l2) * ps32 * v
            )

        delta = _cg_solve(hvp, grad.astype(jnp.float32), n_cg)
        return beta + delta.astype(beta.dtype)

    def hvp(v):
        return tmv(w * mv(v)) + l2 * ps * v

    delta = _cg_solve(hvp, grad, n_cg)
    return beta + delta


@partial(jax.jit, static_argnames=("family", "n_steps", "l1", "l2"))
def fista_epoch(
    X,
    y: jax.Array,
    sample_weight: jax.Array,
    beta: jax.Array,
    step: jax.Array,
    family: str = "gaussian",
    n_steps: int = 50,
    l1: float = 0.0,
    l2: float = 0.0,
    penalty_scale=None,
    offset=None,
) -> jax.Array:
    """``n_steps`` of FISTA for the elastic-net GLM objective (jittable).

    Proximal gradient with Nesterov momentum: the smooth part is the
    negative log-likelihood (+ l2/2·|β|²), the prox is soft-thresholding at
    ``step·l1``.  All FLOPs are the same sandwich-structured matvecs as
    IRLS, so the whole epoch compiles to one XLA program and row-shards the
    same way.  ``step`` ≈ 1/L with L the gradient Lipschitz constant
    (estimated by power iteration in :func:`fit_glm`).
    """
    mv, tmv = _make_mv_tmv(X)

    ps = jnp.ones_like(beta) if penalty_scale is None else penalty_scale

    def grad(b):
        eta = mv(b)
        if offset is not None:
            eta = eta + offset
        mu, _, resid = _family_terms(family, eta, y)
        return -tmv(sample_weight * resid) + l2 * ps * b

    def soft(b, thresh):
        return jnp.sign(b) * jnp.maximum(jnp.abs(b) - thresh, 0.0)

    def body(_, state):
        b, z, t = state
        b_new = soft(z - step * grad(z), step * l1 * ps)
        t_new = 0.5 * (1 + jnp.sqrt(1 + 4 * t * t))
        z_new = b_new + ((t - 1) / t_new) * (b_new - b)
        return (b_new, z_new, t_new)

    b, _, _ = jax.lax.fori_loop(
        0, n_steps, body, (beta, beta, jnp.asarray(1.0, beta.dtype))
    )
    return b


def _power_iteration_lipschitz(mv, tmv, w, k, dtype, n_iter=12):
    """Estimate L = λmax(Xᵀ diag(w) X) by power iteration (matvec-based)."""
    v = jnp.ones((k,), dtype=dtype) / np.sqrt(k)
    lam = jnp.asarray(1.0, dtype)
    for _ in range(n_iter):
        hv = tmv(w * mv(v))
        lam = jnp.linalg.norm(hv)
        v = hv / jnp.maximum(lam, 1e-30)
    return float(lam)


def fit_glm(
    X,
    y,
    sample_weight=None,
    family: str = "gaussian",
    max_iter: int = 25,
    tol: float = 1e-10,
    n_cg: int = 16,
    l2: float = 0.0,
    l1: float = 0.0,
    inner_precision: str = "float32",
    penalty_scale=None,
    offset=None,
    P1=None,
    P2=None,
):
    """Fit a GLM by IRLS; accepts numpy/jax arrays or a tabmat DenseMatrix.

    ``offset`` adds a fixed term to the linear predictor (exposure logs
    etc.).  ``P1``/``P2`` are per-feature penalty multipliers in glum's
    convention: the effective penalties are ``l1·P1[j]`` and ``l2·P2[j]``.

    Returns (beta, n_iter).  Convergence: max |Δβ| < tol.

    ``X`` may be a numpy/jax array, a DenseMatrix, or ANY MatrixBase /
    StandardizedMatrix (SplitMatrix designs included) — non-dense matrices
    are converted to a jit-compatible :class:`DeviceDesign`, so the whole
    step still compiles into one XLA program.
    """
    from .models.base import MatrixBase
    from .models.standardized import StandardizedMatrix

    if isinstance(X, (MatrixBase, StandardizedMatrix)):
        from .parallel.design import DeviceDesign

        X = DeviceDesign.from_matrix(X)
    if not hasattr(X, "blocks"):
        X = jnp.asarray(X)
    y = jnp.asarray(np.asarray(y))
    if sample_weight is None:
        sample_weight = jnp.ones(X.shape[0], dtype=X.dtype)
    else:
        sample_weight = jnp.asarray(np.asarray(sample_weight))

    beta = jnp.zeros(X.shape[1], dtype=X.dtype)
    if penalty_scale is not None:
        penalty_scale = jnp.asarray(np.asarray(penalty_scale), dtype=beta.dtype)
    if P1 is not None or P2 is not None:
        # glum-style per-feature multipliers fold into penalty_scale; when
        # P1 and P2 differ the l1/l2 terms need separate scales — supported
        # for the common case P1 == P2 (or only one penalty active)
        base = penalty_scale if penalty_scale is not None else jnp.ones_like(beta)
        if P1 is not None and P2 is not None and not np.array_equal(
            np.asarray(P1), np.asarray(P2)
        ) and l1 > 0 and l2 > 0:
            raise NotImplementedError(
                "distinct P1 and P2 with both l1 and l2 active are not yet supported"
            )
        pf = P1 if P1 is not None else P2
        penalty_scale = base * jnp.asarray(np.asarray(pf), dtype=beta.dtype)
    if offset is not None:
        offset = jnp.asarray(np.asarray(offset), dtype=beta.dtype)

    if l1 > 0:
        # elastic net → FISTA epochs (IRLS can't handle the nonsmooth term)
        mv, tmv = _make_mv_tmv(X)
        # Lipschitz bound of the smooth part: the IRLS weight is bounded for
        # gaussian/logistic/gamma; poisson (w=mu), inverse_gaussian (w=1/mu)
        # and tweedie (w=mu^{2-p}) are unbounded in mu, so estimate at w=1
        # and add step slack below
        family_base, _ = _parse_family(family)
        caps = {"gaussian": 1.0, "logistic": 0.25, "gamma": 1.0}
        w_cap = caps.get(family_base)
        w_est = sample_weight * (w_cap if w_cap is not None else 1.0)
        L = _power_iteration_lipschitz(
            mv, tmv, w_est, X.shape[1], beta.dtype
        ) + l2
        if w_cap is None:
            L *= 4.0  # slack for the mu-dependent weight near the optimum
        step = jnp.asarray(0.95 / max(L, 1e-30), beta.dtype)
        for it in range(max_iter):
            new_beta = fista_epoch(
                X, y, sample_weight, beta, step,
                family=family, n_steps=50, l1=l1, l2=l2,
                penalty_scale=penalty_scale, offset=offset,
            )
            delta = float(jnp.max(jnp.abs(new_beta - beta)))
            beta = new_beta
            if delta < tol:
                return beta, it + 1
        return beta, max_iter

    for it in range(max_iter):
        new_beta = irls_step(
            X, y, sample_weight, beta, family=family, n_cg=n_cg, l2=l2,
            inner_precision=inner_precision, penalty_scale=penalty_scale,
            offset=offset,
        )
        delta = float(jnp.max(jnp.abs(new_beta - beta)))
        beta = new_beta
        if delta < tol:
            return beta, it + 1
    return beta, max_iter


class GeneralizedLinearRegressor:
    """Minimal sklearn-style GLM estimator over tabmat-tpu matrices.

    The counterpart of the solver the reference library was
    built to serve (glum; reference ``README.md:46``).  Accepts numpy/jax
    arrays, any MatrixBase, a StandardizedMatrix, or a pandas DataFrame
    (routed through ``from_df``).

    Parameters
    ----------
    family: 'gaussian' | 'poisson' | 'logistic' | 'gamma'
    l2: ridge penalty strength
    fit_intercept: prepend a constant column
    max_iter / tol / n_cg: IRLS and inner-CG controls
    """

    def __init__(
        self,
        family: str = "gaussian",
        l2: float = 0.0,
        l1: float = 0.0,
        fit_intercept: bool = True,
        max_iter: int = 50,
        tol: float = 1e-10,
        n_cg: int = 20,
        inner_precision: str = "float32",
        formula: str = None,
    ):
        family = _FAMILY_ALIASES.get(family, family)
        if family not in FAMILIES and not family.startswith("tweedie"):
            raise ValueError(f"Unknown family {family!r}; options: {FAMILIES}")
        if family.startswith("tweedie"):
            _parse_family(family)  # validates the power
        self.family = family
        self.l2 = l2
        self.l1 = l1
        self.fit_intercept = fit_intercept
        self.max_iter = max_iter
        self.tol = tol
        self.n_cg = n_cg
        self.inner_precision = inner_precision
        self.formula = formula
        self._formula_spec = None

    def _design(self, X):
        from .models.base import MatrixBase
        from .models.dense import DenseMatrix
        from .models.split import hstack
        from .models.standardized import StandardizedMatrix

        if not isinstance(X, (MatrixBase, StandardizedMatrix, jax.Array, np.ndarray)):
            from .constructors import from_df

            X = from_df(X)
        if self.fit_intercept:
            ones = np.ones((X.shape[0], 1), dtype=np.dtype(X.dtype))
            if isinstance(X, (np.ndarray, jax.Array)):
                X = hstack([ones, np.asarray(X)])
            else:
                X = hstack([ones, X])
        return X

    def _penalty_scale(self, k_total, has_intercept):
        """Exclude the intercept column from l1/l2 penalties (glum/sklearn
        convention)."""
        if not (has_intercept and (self.l1 > 0 or self.l2 > 0)):
            return None
        ps = np.ones(k_total)
        ps[0] = 0.0
        return ps

    def fit(self, X, y=None, sample_weight=None):
        """Fit by IRLS; stores ``coef_``, ``intercept_``, ``n_iter_``.

        With ``formula='y ~ ...'`` set, pass the dataframe as ``X`` and the
        response is evaluated from the formula's left-hand side.
        """
        if self.formula is not None:
            from .formula import from_formula
            from .formula.engine import materialize_response

            if y is None:
                y = materialize_response(self.formula, X)
            design_mat = from_formula(
                self.formula,
                X,
                include_intercept=self.fit_intercept,
                # estimators need an identifiable design: drop reference
                # levels of categoricals spanned by the intercept
                ensure_full_rank=True,
            )
            self._formula_spec = design_mat.model_spec
            names = design_mat.column_names
            has_icpt = bool(names) and names[0] == "Intercept"
            beta, n_iter = fit_glm(
                design_mat,
                y,
                sample_weight=sample_weight,
                family=self.family,
                max_iter=self.max_iter,
                tol=self.tol,
                n_cg=self.n_cg,
                l2=self.l2,
                l1=self.l1,
                inner_precision=self.inner_precision,
                penalty_scale=self._penalty_scale(design_mat.shape[1], has_icpt),
            )
            beta = np.asarray(beta)
            if self.fit_intercept and names and names[0] == "Intercept":
                self.intercept_ = float(beta[0])
                self.coef_ = beta[1:]
                self.feature_names_ = names[1:]
            else:
                self.intercept_ = 0.0
                self.coef_ = beta
                self.feature_names_ = names
            self.n_iter_ = n_iter
            return self

        design = self._design(X)
        beta, n_iter = fit_glm(
            design,
            y,
            sample_weight=sample_weight,
            family=self.family,
            max_iter=self.max_iter,
            tol=self.tol,
            n_cg=self.n_cg,
            l2=self.l2,
            l1=self.l1,
            inner_precision=self.inner_precision,
            penalty_scale=self._penalty_scale(design.shape[1], self.fit_intercept),
        )
        beta = np.asarray(beta)
        if self.fit_intercept:
            self.intercept_ = float(beta[0])
            self.coef_ = beta[1:]
        else:
            self.intercept_ = 0.0
            self.coef_ = beta
        self.n_iter_ = n_iter
        return self

    def linear_predictor(self, X):
        """``X @ coef_ + intercept_`` (accepts the same X types as fit)."""
        from .models.base import MatrixBase
        from .models.standardized import StandardizedMatrix

        if self._formula_spec is not None and not isinstance(
            X, (MatrixBase, StandardizedMatrix, jax.Array, np.ndarray)
        ):
            # stateful re-materialization with the training category levels
            Xm = self._formula_spec.get_model_matrix(X)
            names = Xm.column_names
            beta_full = (
                np.concatenate([[self.intercept_], self.coef_])
                if names and names[0] == "Intercept"
                else self.coef_
            )
            return np.asarray(Xm.matvec(beta_full))

        if not isinstance(X, (MatrixBase, StandardizedMatrix, jax.Array, np.ndarray)):
            from .constructors import from_df

            X = from_df(X)
        if isinstance(X, (np.ndarray, jax.Array)):
            eta = np.asarray(X) @ self.coef_
        else:
            eta = np.asarray(X.matvec(self.coef_))
        return eta + self.intercept_

    def predict(self, X):
        """Mean prediction on the response scale."""
        eta = self.linear_predictor(X)
        if self.family in ("poisson", "gamma") or self.family.startswith("tweedie"):
            return np.exp(eta)
        if self.family == "logistic":
            return 1 / (1 + np.exp(-eta))
        return eta
