"""Shared helpers of the port's analysis parity tests.

The JAX package's fixture corpus is read out of its three analysis test
files (every ``fixture("…")``/``textwrap.dedent("…")`` snippet and every
source handed to ``_fake_repo``), so a fixture added there is held here
the day it lands. Findings are compared as ``(rule, path, line, message,
key)`` after rebasing the port's package name onto JAX's.
"""

from __future__ import annotations

import ast
import dataclasses
import textwrap
from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO_ROOT = TESTS.parent
JAX_PKG = "vainplex_openclaw_tpu"
PORT_PKG = "vainplex_openclaw_tpu_torch"
JAX_TEST_FILES = ("test_analysis_lint.py", "test_analysis_proto.py",
                  "test_analysis_jax_lint.py")


def jax_fixtures() -> list:
    """``[(id, source)]``: each distinct snippet of JAX's three analysis
    test files, in file order, ``id`` as ``file:line``."""
    out, seen = [], set()
    for name in JAX_TEST_FILES:
        tree = ast.parse((TESTS / name).read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            called = (func.id if isinstance(func, ast.Name) else
                      func.attr if isinstance(func, ast.Attribute) else "")
            args = [a for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)]
            if called in ("fixture", "dedent") and args:
                src = args[0].value
            elif called == "_fake_repo" and args:
                src = args[0].value
            else:
                continue
            src = textwrap.dedent(src)
            if src not in seen:
                seen.add(src)
                out.append((f"{name[:-3]}:{node.lineno}", src))
    for name in JAX_TEST_FILES:  # class-level sources (TABLE_SRC)
        tree = ast.parse((TESTS / name).read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Constant) and isinstance(
                    node.value.value, str) and any(
                    isinstance(t, ast.Name) and t.id.endswith("_SRC")
                    for t in node.targets):
                src = textwrap.dedent(node.value.value)
                if src not in seen:
                    seen.add(src)
                    out.append((f"{name[:-3]}:{node.lineno}", src))
    return out


def rebase(text: str) -> str:
    return text.replace(PORT_PKG, JAX_PKG)


def norm(findings) -> list:
    """Findings of either package as sorted comparable tuples."""
    return sorted((f.rule, rebase(f.path), f.line, rebase(f.message),
                   rebase(f.key)) for f in findings)


def port_of(obj, port_cls):
    """The port's dataclass with a JAX dataclass's field values."""
    return port_cls(**{f.name: getattr(obj, f.name)
                       for f in dataclasses.fields(obj)})


def rebase_to_port(obj, port_cls):
    """A JAX table row as the port's row over the same paths in the port's
    tree (every string field naming JAX's package renamed)."""
    def move(value):
        if isinstance(value, str):
            return value.replace(f"{JAX_PKG}/", f"{PORT_PKG}/")
        if isinstance(value, tuple):
            return tuple(move(v) for v in value)
        if isinstance(value, dict):
            return {k: move(v) for k, v in value.items()}
        return value
    return port_cls(**{f.name: move(getattr(obj, f.name))
                       for f in dataclasses.fields(obj)})
