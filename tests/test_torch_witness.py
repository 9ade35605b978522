"""The port's build-and-launch witness (``analysis/witness.py``).

The twin of ``vainplex_openclaw_tpu/analysis/witness.py::RetraceWitness``
with the same method names: where JAX counts compiles, the port counts
``nvcc`` builds (``ops/_build.builds``). A fake build (a stand-in
compiler that writes an empty library) must fail ``assert_no_retrace``;
the launch counters are read beside the builds and never count against
the budget. Counts are exact integers.
"""

from __future__ import annotations

import os
import stat

import pytest

from vainplex_openclaw_tpu.analysis import RetraceWitness as JaxWitness
from vainplex_openclaw_tpu_torch.analysis import (RetraceWitness,
                                                  launch_counters)
from vainplex_openclaw_tpu_torch.ops import _build
from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
from vainplex_openclaw_tpu_torch.ops import similarity as sim


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A compiler stand-in that writes an empty file at ``-o`` and a build
    directory of the test's own."""
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                      'touch "$2"\n')
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    return script


def test_method_names_are_jax_witness_names():
    for name in ("attach_counter", "probe", "baseline", "traces",
                 "assert_budget", "assert_no_retrace", "names"):
        assert callable(getattr(JaxWitness, name))
        assert callable(getattr(RetraceWitness, name)), name


def test_a_fake_build_fails_assert_no_retrace(fake_nvcc):
    witness = RetraceWitness.armed()
    base = witness.baseline()
    witness.assert_no_retrace()
    witness.assert_no_retrace("builds")
    out = _build.build([("flash_attention", _build.tile_defines((128, 128)))])
    (entry,) = out.values()
    assert not entry["cached"] and os.path.isfile(entry["path"])
    assert witness.traces("builds") == base["builds"] + 1
    with pytest.raises(AssertionError, match="build budget exceeded"):
        witness.assert_no_retrace()
    witness.assert_budget(1)
    # the same library again is cached: no new build
    witness.baseline()
    assert next(iter(_build.build(
        [("flash_attention", _build.tile_defines((128, 128)))]).values()
    ))["cached"]
    witness.assert_no_retrace()


def test_probe_needs_a_builds_count_and_pins_need_a_name():
    witness = RetraceWitness()
    with pytest.raises(TypeError):
        witness.probe("nothing", object())
    witness.probe("builds", _build)
    assert witness.names() == ["builds"]
    with pytest.raises(KeyError, match="never instrumented"):
        witness.assert_no_retrace("typo")
    counts = {"n": 0}
    witness.attach_counter("other", lambda: counts["n"])
    witness.baseline()
    counts["n"] += 2
    assert witness.traces("other") == 2
    with pytest.raises(AssertionError, match="other: 2 new builds"):
        witness.assert_budget(1)


def test_launches_are_read_beside_builds_and_never_budgeted(monkeypatch):
    assert set(launch_counters()) == {"k1", "k2", "k3"}
    witness = RetraceWitness.armed()
    witness.baseline()
    monkeypatch.setattr(fa, "launches", fa.launches + 3)
    monkeypatch.setattr(fa, "stats_launches", fa.stats_launches + 2)
    monkeypatch.setattr(sim, "launches", sim.launches + 1)
    assert (witness.launched("k1"), witness.launched("k2"),
            witness.launched("k3")) == (3, 2, 1)
    witness.assert_no_retrace()  # launches are no builds
    witness.baseline()
    assert witness.launched("k1") == 0
    with pytest.raises(KeyError):
        witness.launched("k9")
