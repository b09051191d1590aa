"""Generate docs/api_reference.md from live docstrings (autodoc analog).

The reference ships a sphinx tree whose ``api.rst`` autodocs the package
surface (reference ``docs/api.rst``); without sphinx,
so this script renders the same content — every public class with its
public methods/properties, every public function, full signatures and
docstrings — to markdown.  Run from the repo root:

    python docs/build_api.py
"""

import inspect
import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import tabmat_tpu as tm  # noqa: E402

FUNCTIONS = [
    "from_df",
    "from_pandas",
    "from_csc",
    "as_tabmat",
    "hstack",
    "from_formula",
]
CLASSES = [
    "MatrixBase",
    "DenseMatrix",
    "SparseMatrix",
    "CategoricalMatrix",
    "SplitMatrix",
    "StandardizedMatrix",
]
GLM = ["GeneralizedLinearRegressor", "fit_glm", "DiagonalResult"]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj, indent=""):
    doc = inspect.getdoc(obj)
    if not doc:
        return f"{indent}*(undocumented)*\n"
    return "\n".join(indent + line for line in doc.splitlines()) + "\n"


def render_function(buf, name, obj, level="##"):
    buf.write(f"{level} `{name}{_sig(obj)}`\n\n")
    buf.write(_doc(obj))
    buf.write("\n")


def render_class(buf, name, cls):
    buf.write(f"## class `{name}{_sig(cls.__init__)}`\n\n")
    bases = ", ".join(b.__name__ for b in cls.__bases__ if b is not object)
    if bases:
        buf.write(f"*Bases: {bases}*\n\n")
    buf.write(_doc(cls))
    buf.write("\n")
    members = []
    for mname, m in inspect.getmembers(cls):
        if mname.startswith("_") and mname not in ("__getitem__", "__matmul__"):
            continue
        if inspect.isfunction(m) or isinstance(
            inspect.getattr_static(cls, mname, None), property
        ):
            members.append((mname, m))
    for mname, m in members:
        static = inspect.getattr_static(cls, mname)
        if isinstance(static, property):
            buf.write(f"### `{name}.{mname}` *(property)*\n\n")
            buf.write(_doc(static.fget or static))
        else:
            buf.write(f"### `{name}.{mname}{_sig(m)}`\n\n")
            buf.write(_doc(m))
        buf.write("\n")


def main():
    buf = io.StringIO()
    buf.write(
        "# API reference\n\n"
        "Generated from docstrings by `docs/build_api.py` — the autodoc\n"
        "analog of the reference's sphinx `api.rst`. Regenerate after any\n"
        "public-surface change.\n\n"
    )
    buf.write("# Constructors\n\n")
    for fname in FUNCTIONS:
        render_function(buf, fname, getattr(tm, fname))
    buf.write("# Matrix classes\n\n")
    for cname in CLASSES:
        render_class(buf, cname, getattr(tm, cname))
    buf.write("# GLM estimation (beyond the reference: a device training loop)\n\n")
    for fname in GLM:
        obj = getattr(tm, fname)
        if inspect.isclass(obj):
            render_class(buf, fname, obj)
        else:
            render_function(buf, fname, obj)
    with open("docs/api_reference.md", "w") as fh:
        fh.write(buf.getvalue())
    print(f"wrote docs/api_reference.md ({len(buf.getvalue().splitlines())} lines)")


if __name__ == "__main__":
    main()
