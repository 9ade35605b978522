"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port either."""

import ast
import os

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "ml_dtypes", "vainplex_openclaw_tpu", "flax"}
PORT = "vainplex_openclaw_tpu_torch"


def top_imports(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def sources(sub: str = "") -> list:
    out = []
    for d, _, files in os.walk(os.path.join(PKG, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(
    p, PKG))
def test_no_jax_anywhere(path):
    assert not top_imports(path) & BANNED


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_port(path):
    names = top_imports(path)
    assert PORT not in names
    assert names <= {"__future__", "json", "math", "re", "numpy", "torch"}


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's and is allowed
    assert PORT.startswith("vainplex_openclaw_tpu")
    assert PORT.split(".", 1)[0] not in BANNED
    assert PORT in top_imports(os.path.join(PKG, "entries", "seam.py"))
