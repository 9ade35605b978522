"""Test set-up of the port's benchmark: the checkout's root on the path,
the ``card`` marker, and a scratch copy of the benchmark to edit.

Run from the checkout's root: ``python3 -m pytest portbench/tests``. The
tests marked ``card`` run only where a CUDA card is visible; whether one
is, is decided inside the ``card`` fixture, never at import.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CHECKPOINT = os.path.join("vainplex_openclaw_tpu", "models", "pretrained",
                          "triage-tiny")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where none is visible")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: this test measures on the card")


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of ``BENCHMARK.json``, ``portbench/`` and the shipped
    checkpoint under ``tmp_path``, with small mixes for the CPU; returns
    (root, edit) where ``edit(relpath, fn)`` rewrites one JSON file."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(os.path.join(ROOT, CHECKPOINT), root / CHECKPOINT)

    def edit(rel: str, fn) -> None:
        path = root / rel
        data = json.loads(path.read_text())
        fn(data)
        path.write_text(json.dumps(data))

    def small_chat(t):
        t.update(sessions=4, pool=96, warmup_s=0.2)
        t["check"]["sample"] = 64
        t["sizes"]["max"] = 256

    def small_bulk(t):
        t.update(pool=3, sizes={"loguniform": [20, 80]})
        t["check"]["sample"] = 64

    edit("portbench/traffic/stage3_chat.json", small_chat)
    edit("portbench/traffic/bulk_triage.json", small_bulk)
    return str(root), edit
