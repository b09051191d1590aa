"""Categorical contrast codings for the formula interface.

Parity target: the contrasts machinery the reference reaches through
formulaic (reference ``tabmat/formula.py:670-711`` delegates ``C()`` to
``formulaic``'s encoder, which supports treatment/sum/helmert/poly and
custom contrast matrices).  tabmat-tpu implements the codings natively:

- ``contr.treatment(base=...)``: one-hot with a chosen reference level;
  stays a CategoricalMatrix (code shift), so the gather/segment-sum
  kernels still apply.
- ``contr.sum()``: deviation coding — level ``j`` vs the grand mean; the
  last level carries ``-1``s (R's ``contr.sum``).
- ``contr.helmert()``: level ``j+1`` vs the mean of levels ``1..j``
  (R's ``contr.helmert``, unscaled).
- ``contr.poly()``: orthonormal polynomial trends over equally spaced
  levels (R's ``contr.poly``).
- ``contr.custom(matrix, labels=...)``: any (K, m) coding matrix.

Non-treatment codings materialize as dense columns ``M[codes, :]`` —
the coded factor then rides the dense contraction path, the natural
mapping for what is algebraically a dense linear re-basis of one-hot.

In full-rank position (no rank reduction requested) every coding spans
the intercept with plain one-hot columns, mirroring how the rank logic
treats un-contrasted categoricals; the coding matrix applies where one
column of rank is dropped.
"""

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["ContrastSpec", "contr", "parse_contrasts_arg"]


def _sum_matrix(k: int) -> np.ndarray:
    m = np.zeros((k, k - 1))
    m[: k - 1, :] = np.eye(k - 1)
    m[k - 1, :] = -1.0
    return m


def _helmert_matrix(k: int) -> np.ndarray:
    m = np.zeros((k, k - 1))
    for j in range(k - 1):
        m[: j + 1, j] = -1.0
        m[j + 1, j] = j + 1.0
    return m


def _poly_matrix(k: int) -> np.ndarray:
    # orthonormal polynomials on the equally spaced points 1..k,
    # degrees 1..k-1 (the constant column is dropped)
    x = np.arange(1, k + 1, dtype=np.float64)
    V = np.vander(x, k, increasing=True)
    Q, R = np.linalg.qr(V)
    Q = Q * np.sign(np.diag(R))  # fix sign so leading coefficients are > 0
    return Q[:, 1:]


_POLY_LABELS = (".L", ".Q", ".C")


def _poly_labels(k: int) -> list:
    return [
        _POLY_LABELS[d] if d < len(_POLY_LABELS) else f"^{d + 1}"
        for d in range(k - 1)
    ]


@dataclass
class ContrastSpec:
    """A parsed contrast request, pickled into the formula state."""

    kind: str  # 'treatment' | 'sum' | 'helmert' | 'poly' | 'custom'
    base: Optional[object] = None  # treatment reference level
    matrix: Optional[np.ndarray] = None  # custom coding matrix (K, m)
    labels: Optional[list] = field(default=None)

    def coding(self, categories: list, reduced: bool):
        """Return ``(M, labels)`` — the (K, m) coding matrix and one label
        fragment per coded column (fed through the column-name format).

        ``reduced`` mirrors the materializer's rank decision: full-rank
        position keeps the one-hot basis for every kind except ``custom``
        (whose matrix is the user's explicit basis either way).
        """
        k = len(categories)
        if self.kind == "custom":
            m = np.asarray(self.matrix, dtype=np.float64)
            if m.ndim != 2 or m.shape[0] != k:
                raise ValueError(
                    f"Custom contrast matrix must have {k} rows (one per "
                    f"level), got shape {m.shape}."
                )
            labels = (
                list(self.labels)
                if self.labels is not None
                else [str(i + 1) for i in range(m.shape[1])]
            )
            if len(labels) != m.shape[1]:
                raise ValueError(
                    "Contrast labels must match the coding matrix columns."
                )
            return m, labels
        if not reduced:
            return np.eye(k), [str(c) for c in categories]
        if k < 2:
            raise ValueError(
                f"Contrast coding needs at least 2 levels, got {k}."
            )
        if self.kind == "sum":
            return _sum_matrix(k), [str(c) for c in categories[:-1]]
        if self.kind == "helmert":
            return _helmert_matrix(k), [str(c) for c in categories[1:]]
        if self.kind == "poly":
            return _poly_matrix(k), _poly_labels(k)
        raise ValueError(f"Unknown contrast kind {self.kind!r}")


class _Factory:
    """``contr.<kind>`` — usable bare or called with arguments."""

    def __init__(self, kind: str):
        self.kind = kind

    def __call__(self, base=None):
        if base is not None and self.kind != "treatment":
            raise ValueError(
                f"contr.{self.kind}() takes no base level argument."
            )
        return ContrastSpec(self.kind, base=base)


class _CustomFactory:
    def __call__(self, matrix, labels=None):
        return ContrastSpec(
            "custom",
            matrix=np.asarray(matrix, dtype=np.float64),
            labels=None if labels is None else list(labels),
        )


class _ContrNamespace:
    """The ``contr`` object exposed inside formula expressions."""

    treatment = _Factory("treatment")
    sum = _Factory("sum")
    helmert = _Factory("helmert")
    poly = _Factory("poly")
    custom = _CustomFactory()


contr = _ContrNamespace()


def parse_contrasts_arg(src: str, context: Optional[dict] = None) -> ContrastSpec:
    """Evaluate a ``C(x, <contrasts>)`` argument source string to a spec.

    Accepts the ``contr.*`` spellings, a bare matrix literal
    (``[[1, 0], [-1, 1], [0, -1]]``), or any expression from the caller's
    context that yields a ContrastSpec or an array.
    """
    namespace = {"contr": contr, "np": np}
    if context:
        namespace.update(context)
    value = eval(src, {"__builtins__": {}}, namespace)  # noqa: S307
    if isinstance(value, ContrastSpec):
        return value
    if isinstance(value, (_Factory, _CustomFactory)):
        return value()  # bare `contr.sum` et al.
    # array-likes are custom coding matrices
    return ContrastSpec("custom", matrix=np.asarray(value, dtype=np.float64))
