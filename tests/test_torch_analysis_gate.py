"""The port's three gates over the port's own tree, and the runner's seams.

``run_analysis(REPO_ROOT)`` over the port (one shared run: it includes the
exhaustive explorer) is ``ok`` with files above 100, every suppression
rationalised and none stale, at most ``SUPPRESSION_CAP`` of them, and its
summary lines parse with JAX's schedule count. The CLI's ``--only`` and
``--json`` behave as JAX's (``tests/test_analysis_proto.py``), and a root
without the port's package exits 2.
"""

from __future__ import annotations

import json

import pytest

from torch_analysis_parity import REPO_ROOT
from vainplex_openclaw_tpu.analysis import findings as j_findings
from vainplex_openclaw_tpu_torch.analysis import (GATES, LintReport,
                                                  gate_of, load_baseline,
                                                  run_analysis)
from vainplex_openclaw_tpu_torch.analysis.__main__ import main

# JAX's cap (tests/test_analysis_lint.py); the port holds JAX's five
# entries at the same sites plus one (train.batch_to, a host upload the
# taint pass cannot tell from a device read), so it stays under it.
SUPPRESSION_CAP = 8


@pytest.fixture(scope="module")
def repo_report():
    return run_analysis(REPO_ROOT)


def test_the_gates_run_clean_on_the_port(repo_report):
    report = repo_report
    assert report.ok, "\n".join(f.render() for f in report.active)
    assert report.files_scanned > 100
    assert len(report.suppressed) <= SUPPRESSION_CAP
    assert not report.stale_keys, report.stale_keys
    assert report.schedules == 77
    assert report.gate_files == {"protolint": 7}


def test_summary_lines_parse(repo_report):
    lines = repo_report.summary().splitlines()
    assert lines[0].startswith("graftlint: files=") \
        and " active=0 " in lines[0]
    assert lines[1].startswith("tracelint: files=")
    assert lines[2].startswith("protolint: files=7 schedules=77 active=0 ")
    assert all(line.endswith(" stale=0") for line in lines)


def test_every_baseline_entry_is_rationalised_and_live(repo_report):
    baseline = load_baseline()
    assert len(baseline) <= SUPPRESSION_CAP
    assert all(r.strip() for r in baseline.values())
    assert sorted(f.key for f, _r in repo_report.suppressed) \
        == sorted(baseline)
    assert all(k.split("::")[1].startswith("vainplex_openclaw_tpu_torch/")
               for k in baseline)
    # JAX's entries all carry over, at the port's paths
    jax_keys = {k.replace("vainplex_openclaw_tpu/",
                          "vainplex_openclaw_tpu_torch/")
                for k in j_findings.load_baseline()}
    assert jax_keys <= set(baseline)


def test_gate_of_routes_rule_families():
    assert gate_of("GL-PROTO-EPOCH") == "protolint"
    assert gate_of("GL-PROTO-SCHED") == "protolint"
    assert gate_of("GL-TRACE-HOSTSYNC") == "tracelint"
    assert gate_of("GL-RETRACE-UNBUCKETED") == "tracelint"
    assert gate_of("GL-LOCK-GUARD") == "graftlint"
    assert gate_of("GL-REDOS") == "graftlint"
    assert [g for g, _p in GATES] == ["graftlint", "tracelint", "protolint"]
    assert GATES == j_findings.GATES


def test_summary_has_one_line_per_gate():
    report = LintReport(files_scanned=140, schedules=77,
                        gate_files={"protolint": 5})
    lines = report.summary().splitlines()
    assert lines[0].startswith("graftlint: files=140 ")
    assert lines[1].startswith("tracelint: files=140 ")
    assert lines[2] == ("protolint: files=5 schedules=77 "
                        "active=0 suppressed=0 stale=0")


def test_only_filter_scopes_summary_and_baseline():
    report = run_analysis(REPO_ROOT, only=["GL-PROTO-EPOCH"])
    assert report.gates_run == ("protolint",)
    assert report.active == []
    lines = report.summary().splitlines()
    assert len(lines) == 1 and lines[0].startswith("protolint: ")
    assert report.suppressed == [] and report.stale_keys == []


def test_cli_json_artifact_and_exit_code(tmp_path):
    out = tmp_path / "findings.json"
    rc = main(["--root", str(REPO_ROOT), "--only", "GL-PROTO-EPOCH",
               "--json", str(out)])
    assert rc == 0
    data = json.loads(out.read_text(encoding="utf-8"))
    assert set(data["gates"]) == {"protolint"}
    assert data["gates"]["protolint"]["active"] == 0
    assert data["gates"]["protolint"]["files"] == 7


def test_cli_comma_separated_only(capsys):
    rc = main(["--root", str(REPO_ROOT),
               "--only", "GL-PROTO-EPOCH,GL-PROTO-ORDER"])
    assert rc == 0
    outerr = capsys.readouterr()
    assert outerr.out.splitlines()[-1].startswith("protolint: files=7 ")


def test_cli_json_on_stdout_and_a_root_without_the_port(tmp_path, capsys):
    rc = main(["--root", str(REPO_ROOT), "--only", "GL-PROTO-ACK",
               "--json"])
    assert rc == 0
    data = json.loads(capsys.readouterr().out)
    assert data["ok"] and set(data["gates"]) == {"protolint"}
    (tmp_path / "vainplex_openclaw_tpu").mkdir()   # JAX's tree only
    assert main(["--root", str(tmp_path)]) == 2
    assert "no package under" in capsys.readouterr().err
