"""The port and chip_smoke.py import neither jax nor the JAX package.

A fresh interpreter imports every module of ``vainplex_openclaw_tpu_torch``
and ``chip_smoke`` (whose work stays under its ``__main__`` check, so the
import runs nothing) and then reports what ``sys.modules`` holds. An AST
scan of the same files finds no such import anywhere, not even inside a
function.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "vainplex_openclaw_tpu_torch")
FORBIDDEN_ROOTS = ("jax", "jaxlib", "ml_dtypes", "optax",
                   "vainplex_openclaw_tpu")


def forbidden(name: str) -> bool:
    root = name.split(".", 1)[0]
    return root in FORBIDDEN_ROOTS  # vainplex_openclaw_tpu_torch: root differs


def port_files() -> list:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def port_modules() -> list:
    mods = []
    for path in port_files():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    return mods


def test_forbidden_matcher():
    assert forbidden("jax") and forbidden("jax.numpy")
    assert forbidden("vainplex_openclaw_tpu") and forbidden("optax")
    assert forbidden("vainplex_openclaw_tpu.models.encoder")
    assert not forbidden("vainplex_openclaw_tpu_torch")
    assert not forbidden("vainplex_openclaw_tpu_torch.models.encoder")
    assert not forbidden("jaxtyping_like") and not forbidden("torch")


def test_subprocess_import_leaves_no_jax_module():
    script = (
        "import importlib, json, sys\n"
        f"mods = {port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, "importing chip_smoke or the port printed output"
    loaded = json.loads(lines[0])
    for mod in ("vainplex_openclaw_tpu_torch.models.serve",
                "vainplex_openclaw_tpu_torch.models.long_context",
                "vainplex_openclaw_tpu_torch.parallel.mesh",
                "vainplex_openclaw_tpu_torch.parallel.plan",
                "vainplex_openclaw_tpu_torch.parallel.ring_attention",
                "vainplex_openclaw_tpu_torch.models.data",
                "vainplex_openclaw_tpu_torch.models.moe",
                "vainplex_openclaw_tpu_torch.models.train",
                "vainplex_openclaw_tpu_torch.parallel.sharded_train",
                "vainplex_openclaw_tpu_torch.ops.similarity",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.classifier",
                "vainplex_openclaw_tpu_torch.knowledge.embeddings",
                "vainplex_openclaw_tpu_torch.storage.lifecycle",
                "vainplex_openclaw_tpu_torch.models.registry",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.redactor",
                "vainplex_openclaw_tpu_torch.utils.llm_json",
                "vainplex_openclaw_tpu_torch.analysis",
                "vainplex_openclaw_tpu_torch.analysis.witness",
                "vainplex_openclaw_tpu_torch.ops.search_common",
                "vainplex_openclaw_tpu_torch.ops.kernel_search",
                "vainplex_openclaw_tpu_torch.parallel.plan_search",
                "vainplex_openclaw_tpu_torch.graft_entry",
                "vainplex_openclaw_tpu_torch.core.api",
                "vainplex_openclaw_tpu_torch.storage.atomic",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.analyzer",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.chains",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.clusters",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.events",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.outputs",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.report",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.signals",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer."
                "signal_patterns",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer.source",
                "vainplex_openclaw_tpu_torch.cortex.trace_analyzer."
                "nats_source",
                "vainplex_openclaw_tpu_torch.resilience.faults",
                "vainplex_openclaw_tpu_torch.models.prng"):
        assert mod in loaded, mod
    assert "chip_smoke" in loaded
    assert [m for m in loaded if forbidden(m)] == []


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and forbidden(a.value)]
    assert bad == []


def test_chip_smoke_refuses_without_a_card():
    """No CUDA device: exit non-zero and print no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
