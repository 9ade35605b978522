"""``chip_smoke.py``'s analysis phase, run here on the CPU as the card's
machine runs it: the port's gates as a child process over this checkout
(exit 0, three summary lines with active=0, files above 100, JAX's
schedule count), then the control, a copy of the port's tree with the
ack-without-commit shape injected into ``InProcessWorker._ack``, which
must exit 1 with that one finding. A control that misses the injection
site must fail the phase."""

from __future__ import annotations

import pytest

# the bounds module puts the repository root on the path for chip_smoke
import test_torch_chip_smoke_bounds  # noqa: F401

import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu.analysis import explore as j_explore
from vainplex_openclaw_tpu.analysis import proto_table as j_pt


def test_the_phase_s_schedule_count_is_jax_s():
    assert chip_smoke.ANALYSIS_SCHEDULES == sum(
        len(j_explore.schedules(c)) for c in j_pt.EXPLORER_CONFIGS)


def test_the_analysis_leg_on_the_cpu(tmp_path):
    leg = chip_smoke.analysis_leg(str(tmp_path))
    gates = leg["gates"]
    assert sorted(gates) == sorted(chip_smoke.ANALYSIS_GATES)
    assert all(g["active"] == 0 and g["stale"] == 0 for g in gates.values())
    assert gates["graftlint"]["files"] > chip_smoke.ANALYSIS_MIN_FILES
    assert gates["protolint"]["schedules"] == 77
    assert leg["control"]["rc"] == 1
    assert leg["control"]["active"] == [chip_smoke.ANALYSIS_CONTROL_KEY]
    assert leg["seconds"] > 0 and leg["control"]["seconds"] > 0


def test_a_control_without_its_injection_site_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "ANALYSIS_INJECT_AT",
                        "    def _no_such_method(self):\n")
    with pytest.raises(chip_smoke.SmokeFailure, match="injection site"):
        chip_smoke.analysis_control_tree(str(tmp_path / "control"))
