"""Finds every piece of a cell by its name in ``BENCHMARK.json``.

Nothing here knows a cell, a configuration, a mix or a metric: a later
change adds one by adding files and entries.

- the cell: an entry of ``workloads`` (its ``config`` and ``traffic``);
- the configuration: ``portbench/configs/<config>.json``;
- the traffic mix: ``portbench/traffic/<traffic>.json``, read by
  ``traffic/generator.py``; its ``entry`` key names the module
  ``portbench/entries/<entry>.py`` of the program's entry it calls;
- the limits of its correctness check: ``portbench/limits/<cell>.json``;
- a metric: its reader ``portbench/metrics/<base>.py``, where ``<base>`` is
  the metric's name up to its first dot (``k1_roofline.chat`` and
  ``k1_roofline.triage`` share ``metrics/k1_roofline.py``). The cell reports
  every end-to-end metric whose ``workloads`` name it (or that has none,
  like ``setup_s``), and in a traced run every per-layer metric that does.
"""

from __future__ import annotations

import importlib.util
import json
import os

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.pkg = os.path.join(root, "portbench")
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        return _json(os.path.join(self.pkg, "configs",
                                  cell["config"] + ".json"))

    def traffic(self, cell: dict) -> dict:
        return _json(os.path.join(self.pkg, "traffic",
                                  cell["traffic"] + ".json"))

    def limits(self, cell: dict) -> dict:
        return _json(os.path.join(self.pkg, "limits", cell["name"] + ".json"))

    def entry(self, traffic: dict):
        name = traffic["entry"]
        return _module(os.path.join(self.pkg, "entries", name + ".py"),
                       f"portbench_entry_{name}")

    def metrics(self, cell: dict, traced: bool) -> list:
        """The metric entries the cell reports in this kind of run."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def reader(self, metric: dict):
        base = metric["name"].split(".", 1)[0]
        return _module(os.path.join(self.pkg, "metrics", base + ".py"),
                       f"portbench_metric_{base}")
