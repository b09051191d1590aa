"""tabmat-tpu: matrix representations for GLM-style tabular data, in JAX.

A from-scratch JAX/XLA framework with the capabilities of
Quantco/tabmat: dense, sparse, categorical, split, and standardized matrix
types behind a single ``MatrixBase`` API — ``matvec``, ``transpose_matvec``,
the sandwich product ``Xᵀ diag(d) X``, active-set row/column restriction,
weighted standardization — plus dataframe/formula constructors.

Compute-path design (see SURVEY.md §7 for the blueprint):

- dense sandwich → one contraction at pinned full precision, with the
  diag(d) scaling fused by XLA
- categorical ops → gather / argsort+cumsum segment reductions (no scatter)
- sparse ops → CSR/CSC boundary-segmented cumsum kernels
- standardized ops → rank-1 corrections, never densified
- multi-chip → row-sharded operands over a jax.sharding.Mesh with psum'd
  partial sandwiches (``tabmat_tpu.parallel``)
"""

from ._config import initialize as _initialize

_initialize()

from .models import (  # noqa: F401,E402
    CategoricalMatrix,
    DenseMatrix,
    MatrixBase,
    SparseMatrix,
    SplitMatrix,
    StandardizedMatrix,
    as_tabmat,
    hstack,
)
from .constructors import from_csc, from_df, from_pandas  # noqa: F401,E402
from .formula import from_formula  # noqa: F401,E402
from .ops.diag import DiagonalResult  # noqa: F401,E402
from .glm import GeneralizedLinearRegressor, fit_glm  # noqa: F401,E402

__version__ = "0.6.0"

__all__ = [
    "DenseMatrix",
    "MatrixBase",
    "StandardizedMatrix",
    "SparseMatrix",
    "SplitMatrix",
    "CategoricalMatrix",
    "DiagonalResult",
    "from_csc",
    "from_formula",
    "from_pandas",
    "from_df",
    "as_tabmat",
    "hstack",
    "GeneralizedLinearRegressor",
    "fit_glm",
]
