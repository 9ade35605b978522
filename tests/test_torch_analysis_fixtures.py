"""The port's analysis passes against the JAX package's on JAX's own
fixture corpus, and on the torch spellings the port adds.

Every snippet of JAX's three analysis test files (``tests/
test_analysis_lint.py``, ``test_analysis_proto.py``,
``test_analysis_jax_lint.py``) goes through each fixture entry point of
both packages, with the specs, rules and tables those files use, and the
findings must be equal as ``(rule, path, line, message, key)`` once the
port's package name is rebased onto JAX's: the lock-discipline,
lock-order, epoch, fence, order, ack, trace, retrace (construction, call
sites, table, dtype) and shard (axis, donation, rule) checks. The
drift and baseline checks, which read trees and files, are held the same
way on JAX's cases. Then the torch-only spellings (``.cpu()``, a
``torch.rand`` without ``generator=``, a kernel build reached per call,
the port's spec tuples) each get a good and a bad fixture.
"""

from __future__ import annotations

import dataclasses
import textwrap

import pytest

import test_analysis_jax_lint as jax_trace_tests
import test_analysis_lint as jax_lint_tests
import test_analysis_proto as jax_proto_tests
from torch_analysis_parity import (JAX_PKG, PORT_PKG, jax_fixtures, norm,
                                   port_of)
from vainplex_openclaw_tpu.analysis import drift as j_drift
from vainplex_openclaw_tpu.analysis import findings as j_findings
from vainplex_openclaw_tpu.analysis import jit_table as j_jit
from vainplex_openclaw_tpu.analysis import lock_order as j_order
from vainplex_openclaw_tpu.analysis import locks as j_locks
from vainplex_openclaw_tpu.analysis import proto as j_proto
from vainplex_openclaw_tpu.analysis import proto_table as j_pt
from vainplex_openclaw_tpu.analysis import retrace as j_retrace
from vainplex_openclaw_tpu.analysis import sharding as j_sharding
from vainplex_openclaw_tpu.analysis import tracing as j_tracing
from vainplex_openclaw_tpu_torch.analysis import drift as p_drift
from vainplex_openclaw_tpu_torch.analysis import findings as p_findings
from vainplex_openclaw_tpu_torch.analysis import jit_table as p_jit
from vainplex_openclaw_tpu_torch.analysis import lock_order as p_order
from vainplex_openclaw_tpu_torch.analysis import locks as p_locks
from vainplex_openclaw_tpu_torch.analysis import proto as p_proto
from vainplex_openclaw_tpu_torch.analysis import proto_table as p_pt
from vainplex_openclaw_tpu_torch.analysis import retrace as p_retrace
from vainplex_openclaw_tpu_torch.analysis import sharding as p_sharding
from vainplex_openclaw_tpu_torch.analysis import tracing as p_tracing

FIXTURES = jax_fixtures()

# The rules JAX's fixtures run under, as the JAX tests build them.
FENCE_RULES = (
    jax_proto_tests.FENCE_RULE,
    j_pt.FenceRule(module="f.py", cls="J", write_calls=("replace",),
                   guarded=(("_write_meta", "callers hold the commit lock "
                             "and re-checked the fence"),)),
    j_pt.FenceRule(module="f.py", cls="J", write_calls=("replace",),
                   guarded=(("_write_meta", " "),)),
    j_pt.FenceRule(module="f.py", cls="J", write_calls=("replace",),
                   guarded=(("gone", "used to write"),)),
    j_pt.FenceRule(module="f.py", cls="J", write_calls=(),
                   write_fault_sites=("journal.append",)),
)
ORDER_RULES = (jax_proto_tests.order_rule(),
               jax_proto_tests.order_rule(forbid_early=False))
ACK_RULES = (jax_proto_tests.TestAckLint.RELEASE,
             jax_proto_tests.TestAckLint.MARK)
EPOCH_EXEMPT = ((), (("S.identity", "same-grant identity check"),),
                (("S.identity", ""),), (("clean", "stale"),))
TRACE_ENTRIES = (jax_trace_tests.ENTRY,
                 j_jit.JitEntry(module="fixture.py", jit_fns=("build.inner",)),
                 j_jit.JitEntry(module="fixture.py",
                                jit_fns=("vanished_fn",)))
AXES = jax_trace_tests.TestShardAxis.AXES
TABLE_SRC = textwrap.dedent(jax_trace_tests.TestRetraceCallSites.TABLE_SRC)


def _source_checks(src: str, side: str) -> dict:
    """``{check: findings}`` of every source-level fixture entry point."""
    port = side == "port"
    locks, order, proto, tracing, retrace, sharding, pt, jit = (
        (p_locks, p_order, p_proto, p_tracing, p_retrace, p_sharding, p_pt,
         p_jit) if port else
        (j_locks, j_order, j_proto, j_tracing, j_retrace, j_sharding, j_pt,
         j_jit))

    def conv(obj, cls):
        return port_of(obj, cls) if port else obj

    out = {"locks": locks.check_module_source(
        src, "fixture.py", [conv(jax_lint_tests.SPEC, locks.GuardSpec)])}
    out["lock_order"] = order.check_source(src)
    for i, exempt in enumerate(EPOCH_EXEMPT):
        out[f"epoch{i}"] = proto.check_epoch_source(src, "f.py", exempt)
    for i, rule in enumerate(FENCE_RULES):
        out[f"fence{i}"] = proto.check_fence_source(
            src, "f.py", conv(rule, pt.FenceRule))
    for i, rule in enumerate(ORDER_RULES):
        out[f"order{i}"] = proto.check_order_source(
            src, "f.py", [conv(rule, pt.OrderRule)])
    out["ack"] = proto.check_ack_source(
        src, "f.py", [conv(r, pt.AckRule) for r in ACK_RULES])
    for i, entry in enumerate(TRACE_ENTRIES):
        out[f"trace{i}"] = tracing.check_source(
            src, "fixture.py", [conv(entry, jit.JitEntry)])
    out["dtype"] = retrace.check_dtype_source(src, "m.py")
    out["axis"] = sharding.check_axis_source(src, "m.py", AXES)
    out["donate"] = sharding.check_donation_source(src, "m.py")
    out["rules"] = sharding.check_rule_tables_source(src, "m.py")
    return out


def _tree_checks(src: str, root, side: str) -> dict:
    """``{check: findings}`` of the retrace passes that read a tree: the
    snippet as ``mod.py`` (construction, table) and as ``caller.py``
    beside JAX's ``TABLE_SRC`` (call sites), under the side's package."""
    pkg = PORT_PKG if side == "port" else JAX_PKG
    retrace = p_retrace if side == "port" else j_retrace
    Entry = (p_jit if side == "port" else j_jit).JitEntry
    (root / pkg).mkdir(parents=True)
    rel, caller = f"{pkg}/mod.py", f"{pkg}/caller.py"
    (root / rel).write_text(src)
    out = {
        "construct": retrace.check_jit_construction(
            root, (Entry(module=rel, jit_fns=()),)),
        "construct_builder": retrace.check_jit_construction(
            root, (Entry(module=rel, jit_fns=(), builders=("build",)),)),
        "wrapper": retrace.check_table(root, (Entry(
            module=rel, jit_fns=(), wrapper="wrapper",
            shape_policy="bucketed"),)),
        "no_rationale": retrace.check_table(root, (Entry(
            module=rel, jit_fns=("hot",), shape_policy="fixed",
            rationale=""),)),
    }
    (root / rel).write_text(TABLE_SRC)
    (root / caller).write_text(src)
    for i, fixed in enumerate(((), ((caller, "serve", "ok"),
                                    (caller, "gone_fn", "typo'd")))):
        out[f"calls{i}"] = retrace.check_call_sites(root, (Entry(
            module=rel, jit_fns=("hot",), entry_names=("hot",),
            shape_policy="fixed", rationale="fixture",
            fixed_callers=fixed),))
    return out


def _same(jax_out: dict, port_out: dict) -> None:
    assert jax_out.keys() == port_out.keys()
    for check in jax_out:
        got, want = port_out[check], jax_out[check]
        if check == "lock_order":   # (cycle, site) pairs, not findings
            assert got == want, check
        else:
            assert norm(got) == norm(want), check


def test_the_corpus_is_whole():
    """The extraction reads every JAX fixture: each family's known-bad
    snippets are in it."""
    assert len(FIXTURES) >= 70
    found = {check for _id, src in FIXTURES
             for check, fs in _source_checks(src, "jax").items() if fs}
    assert {"locks", "lock_order", "epoch0", "fence0", "order0", "ack",
            "trace0", "dtype", "axis", "donate", "rules"} <= found


@pytest.mark.parametrize("src", [s for _i, s in FIXTURES],
                         ids=[i for i, _s in FIXTURES])
def test_jax_fixture_gives_jax_s_findings(src, tmp_path):
    _same(_source_checks(src, "jax"), _source_checks(src, "port"))
    _same(_tree_checks(src, tmp_path / "jax", "jax"),
          _tree_checks(src, tmp_path / "port", "port"))


# ── drift and baseline, on JAX's cases ─────────────────────────────────


def test_fault_site_cases_match(tmp_path):
    for pkg in (JAX_PKG, PORT_PKG):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "mod.py").write_text(
            "from .faults import maybe_fail\n"
            "def f():\n    maybe_fail('audit.append')\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_x.py").write_text(
        "from x import FaultSpec\n"
        "bad = FaultSpec('audit.apend', rate=0.5)\n"
        "good = FaultSpec('audit.*', rate=0.5)\n"
        "clk = FaultSpec('clock', steps=(1,))\n")
    got = p_drift.check_fault_sites(tmp_path)
    assert norm(got) == norm(j_drift.check_fault_sites(tmp_path))
    assert [f.detail for f in got] == ["tests/test_torch_x.py:audit.apend"]


def test_chip_smoke_fault_sites_are_read(tmp_path):
    """The card's chaos phase lives in chip_smoke.py: a mistyped site
    there is a finding (JAX's pass reads tests/ only)."""
    (tmp_path / PORT_PKG).mkdir()
    (tmp_path / PORT_PKG / "mod.py").write_text(
        "def f():\n    maybe_fail('checkpoint.write')\n")
    (tmp_path / "chip_smoke.py").write_text(
        "plan = FaultPlan([FaultSpec('checkpoint.writ', steps=(2,))])\n"
        "ok = FaultSpec('checkpoint.write', steps=(2,))\n")
    found = p_drift.check_fault_sites(tmp_path)
    assert [f.detail for f in found] == ["chip_smoke.py:checkpoint.writ"]


def test_config_key_case_matches(tmp_path, monkeypatch):
    (tmp_path / "m.py").write_text(textwrap.dedent("""
        MY_DEFAULTS = {"alpha": 1}
        def f(cfg):
            return cfg.get("alpha"), cfg.get("beta")
        """))
    sites = (("m.py", ("MY_DEFAULTS",), ("cfg",), None),)
    monkeypatch.setattr(j_drift, "CONFIG_SITES", sites)
    monkeypatch.setattr(p_drift, "CONFIG_SITES", sites)
    got = p_drift.check_config_keys(tmp_path)
    assert len(got) == 1 and norm(got) == norm(
        j_drift.check_config_keys(tmp_path))


@pytest.mark.parametrize("case", ["record_key", "metric"])
def test_bench_ci_cases_match(tmp_path, case):
    """check_bench_ci keeps JAX's signature and verdicts on JAX's two
    fixtures; the port passes its paths, since it has no bench of its
    own yet."""
    wf = tmp_path / ".github" / "workflows"
    wf.mkdir(parents=True)
    if case == "record_key":
        (wf / "ci.yml").write_text(
            "      - run: |\n"
            "          python - <<'EOF'\n"
            "          import bench\n"
            "          rec = bench.bench_thing()\n"
            "          assert rec[\"real_field\"] > 0\n"
            "          assert rec[\"ghost_field\"] > 0\n"
            "          fo = rec[\"real_field\"]\n"
            "          EOF\n")
        (tmp_path / "bench.py").write_text(
            '"""prose mentioning ghost_field must not count as a key"""\n'
            'def bench_thing():\n'
            '    return {"metric": "m", "real_field": 1}\n')
    else:
        (wf / "ci.yml").write_text(
            'assert rec["metric"] == "ghost_metric"\n'
            "run: python -c 'import bench; bench.bench_missing()'\n"
            "bench.bench_missing(n=1)\n")
        (tmp_path / "bench.py").write_text(
            'def bench_real():\n    return {"metric": "real_metric"}\n')
        for pkg in (JAX_PKG, PORT_PKG):
            (tmp_path / pkg / "slo").mkdir(parents=True)
    want = j_drift.check_bench_ci(tmp_path)
    got = p_drift.check_bench_ci(tmp_path, ci_path=".github/workflows/ci.yml",
                                 bench_path="bench.py")
    assert want and norm(got) == norm(want)


def test_bench_rule_reads_nothing_of_the_repo(tmp_path):
    """No port bench yet: the pass never reads JAX's bench.py or CI."""
    wf = tmp_path / ".github" / "workflows"
    wf.mkdir(parents=True)
    (wf / "ci.yml").write_text('assert rec["metric"] == "ghost_metric"\n')
    (tmp_path / "bench.py").write_text("def bench_real():\n    pass\n")
    (tmp_path / PORT_PKG).mkdir()
    assert j_drift.check_bench_ci(tmp_path)
    assert not [f for f in p_drift.run(tmp_path)[0]
                if f.rule == "GL-DRIFT-BENCH"]


@pytest.mark.parametrize("case", ["unbaselined", "rationale", "empty",
                                  "stale"])
def test_baseline_cases_match(case):
    out = {}
    for side, mod in (("jax", j_findings), ("port", p_findings)):
        report = mod.LintReport()
        f = mod.Finding("GL-X", "a.py", 3, "boom", detail="a")
        baseline = {"unbaselined": {}, "rationale": {f.key: "benign"},
                    "empty": {f.key: "  "},
                    "stale": {"GL-X::gone.py::x": "was fixed"}}[case]
        mod.apply_baseline([] if case == "stale" else [f], baseline, report)
        out[side] = (norm(report.active),
                     norm(x for x, _r in report.suppressed),
                     report.stale_keys, report.ok, report.summary(),
                     report.to_dict())
    assert out["port"] == out["jax"]


# ── the torch spellings, each with a good and a bad fixture ────────────

ENTRY = p_jit.JitEntry(module="fixture.py", jit_fns=("f",), static=("cfg",))


def _trace(src: str) -> list:
    return [(f.rule, f.detail) for f in p_tracing.check_source(
        textwrap.dedent(src), "fixture.py", [ENTRY])]


def test_cpu_and_numpy_on_a_device_tensor_are_host_syncs():
    assert _trace("""
        def f(x, cfg):
            return x.sum().cpu(), x.numpy()
        """) == [("GL-TRACE-HOSTSYNC", "f:cpu:1"),
                 ("GL-TRACE-HOSTSYNC", "f:numpy:1")]
    # metadata is host state: .device, .dim(), .numel() are not syncs
    assert _trace("""
        def f(x, cfg):
            if x.device.type == "cuda" and x.dim() == 2 and x.numel():
                return x.to(x.device)
            return x
        """) == []


def test_an_unseeded_torch_draw_is_impure():
    assert _trace("""
        import torch
        def f(x, cfg):
            noise = torch.randn(4)
            x.uniform_()
            return x + noise + torch.rand_like(x)
        """) == [("GL-TRACE-IMPURE", "f:torch.randn"),
                 ("GL-TRACE-IMPURE", "f:x.uniform_"),
                 ("GL-TRACE-IMPURE", "f:torch.rand_like")]
    assert _trace("""
        import torch
        def f(x, cfg, gen):
            x.uniform_(generator=gen)
            return x + torch.randn(4, generator=gen)
        """) == []


def _build_tree(tmp_path, src: str):
    (tmp_path / PORT_PKG / "ops").mkdir(parents=True)
    rel = f"{PORT_PKG}/ops/mod.py"
    (tmp_path / rel).write_text(textwrap.dedent(src))
    return rel


def test_a_kernel_build_reached_per_call_is_flagged(tmp_path):
    rel = _build_tree(tmp_path, """
        from . import _build
        def launch(q):
            _build.build(["flash_attention"])
            return q
        """)
    found = p_retrace.check_jit_construction(
        tmp_path, (p_jit.JitEntry(module=rel),))
    assert [(f.rule, f.detail) for f in found] == [
        ("GL-RETRACE-UNBUCKETED", "percall-build:launch")]
    # the same jax pass sees no jit there at all
    assert j_retrace.check_jit_construction(
        tmp_path, (j_jit.JitEntry(module=rel),)) == []


def test_a_declared_or_memoized_build_is_clean(tmp_path):
    rel = _build_tree(tmp_path, """
        import ctypes
        import functools
        from ._build import build
        def measure(point):
            build([("flash_attention", point)])
        @functools.lru_cache(maxsize=None)
        def lib(name):
            return ctypes.CDLL(name)
        """)
    assert p_retrace.check_jit_construction(tmp_path, (p_jit.JitEntry(
        module=rel, builders=("measure",)),)) == []
    found = p_retrace.check_jit_construction(
        tmp_path, (p_jit.JitEntry(module=rel),))
    assert [f.detail for f in found] == ["percall-build:measure"]


def test_an_undeclared_module_that_builds_is_flagged(tmp_path):
    rel = _build_tree(tmp_path, """
        import ctypes
        LIB = ctypes.CDLL("libx.so")
        """)
    found = p_retrace.check_jit_construction(tmp_path, ())
    assert [f.detail for f in found] == [f"undeclared-module:{rel}"]


def test_port_spec_tuples_are_read():
    src = textwrap.dedent("""
        ENCODER_RULES = (
            ("attn/q$", (None, "tp")),
            ("attn/o$", ("pt", None)),
            ("attn/q$", ()),
        )
        PLAN = ShardingPlan(family="x", rules=ENCODER_RULES,
                            data_spec=("dpp",), axes=("dp", "tp"))
        GATES = (("graftlint", ("GL-LOCK", "GL-REDOS")),)
        """)
    axis = p_sharding.check_axis_source(src, "m.py", {"dp", "tp"})
    assert sorted(f.detail for f in axis) == ["axis:dpp:7", "axis:pt:4"]
    rules = p_sharding.check_rule_tables_source(src, "m.py")
    assert [f.detail for f in rules] == ["dup:attn/q$:2"]
    # JAX's pass reads P() calls only: the port's form is its own
    assert j_sharding.check_axis_source(src, "m.py", {"dp", "tp"}) == []


def test_fixture_rows_convert_both_ways():
    """The rows this file converts keep every field (a new field on one
    side would silently drop here)."""
    for jax_cls, port_cls in ((j_locks.GuardSpec, p_locks.GuardSpec),
                              (j_pt.FenceRule, p_pt.FenceRule),
                              (j_pt.OrderRule, p_pt.OrderRule),
                              (j_pt.AckRule, p_pt.AckRule),
                              (j_pt.EpochRule, p_pt.EpochRule),
                              (j_pt.ExplorerConfig, p_pt.ExplorerConfig),
                              (j_jit.JitEntry, p_jit.JitEntry)):
        assert [f.name for f in dataclasses.fields(jax_cls)] == \
            [f.name for f in dataclasses.fields(port_cls)]
