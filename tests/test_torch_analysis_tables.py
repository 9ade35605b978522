"""The port's analysis tables over the port's own tree, held against the
JAX package's passes run with those same tables.

Where a JAX pass takes its table or package as an argument
(``locks.run(root, specs=)``, ``lock_order.run(root, package=)``,
``drift.registered_fault_sites(root, package=)``, ``proto.run(root,
epoch_rules=, …)``, ``retrace.check_table(root, table)``), JAX's pass with
the port's table over the port's tree must find what the port's pass
finds. The row mapping is pinned too: every JAX ``GUARDED``, protocol,
explorer, config-site and ``JIT_TABLE`` row has its port row, apart from
the listed deviations. Then ``wrap_clock`` (JAX's
``tests/test_resilience_faults.py`` case), the SHARD-DONATE rule that no
torch construct can trigger, and the guard against JAX package names left
in the port's gates.
"""

from __future__ import annotations

import ast
import dataclasses

import numpy as np
import pytest

from torch_analysis_parity import (JAX_PKG, PORT_PKG, REPO_ROOT, norm,
                                   port_of, rebase_to_port)
from vainplex_openclaw_tpu.analysis import drift as j_drift
from vainplex_openclaw_tpu.analysis import jit_table as j_jit
from vainplex_openclaw_tpu.analysis import lock_order as j_order
from vainplex_openclaw_tpu.analysis import locks as j_locks
from vainplex_openclaw_tpu.analysis import proto as j_proto
from vainplex_openclaw_tpu.analysis import proto_table as j_pt
from vainplex_openclaw_tpu.analysis import retrace as j_retrace
from vainplex_openclaw_tpu_torch import analysis as p_analysis
from vainplex_openclaw_tpu_torch.analysis import drift as p_drift
from vainplex_openclaw_tpu_torch.analysis import jit_table as p_jit
from vainplex_openclaw_tpu_torch.analysis import lock_order as p_order
from vainplex_openclaw_tpu_torch.analysis import locks as p_locks
from vainplex_openclaw_tpu_torch.analysis import proto as p_proto
from vainplex_openclaw_tpu_torch.analysis import proto_table as p_pt
from vainplex_openclaw_tpu_torch.analysis import retrace as p_retrace
from vainplex_openclaw_tpu_torch.analysis import sharding as p_sharding

# JAX rows the port's table changes, each with its reason in the row.
GUARDED_DEVIATIONS = {
    # no jitted forward to cache: the port's forward runs eagerly
    ("LocalEmbeddings", "_init_lock"): {"_forward_jit"},
}


# ── JAX's passes, the port's tables ────────────────────────────────────


def test_locks_pass_with_the_port_s_table():
    specs = [port_of(s, j_locks.GuardSpec) for s in p_locks.GUARDED]
    want, n_jax = j_locks.run(REPO_ROOT, specs=specs)
    got, n_port = p_locks.run(REPO_ROOT)
    assert n_port == n_jax == len(p_locks.GUARDED)
    assert norm(got) == norm(want) and len(got) == 5


def test_lock_order_pass_over_the_port_s_package():
    want, n_jax = j_order.run(REPO_ROOT, package=PORT_PKG)
    got, n_port = p_order.run(REPO_ROOT)
    assert n_port == n_jax > 100 and got == want == []
    assert p_order.build_graph(REPO_ROOT) == j_order.build_graph(
        REPO_ROOT, package=PORT_PKG)


def test_fault_sites_of_the_port_s_package():
    got = p_drift.registered_fault_sites(REPO_ROOT)
    assert got == j_drift.registered_fault_sites(REPO_ROOT, package=PORT_PKG)
    # the port registers every site the JAX package does, clock included
    assert got == j_drift.registered_fault_sites(REPO_ROOT)
    assert "clock" in got and "cluster.worker.crash" in got


def test_proto_pass_with_the_port_s_tables():
    def conv(rules, cls):
        return tuple(port_of(r, cls) for r in rules)

    want = j_proto.run(
        REPO_ROOT, epoch_rules=conv(p_pt.EPOCH_RULES, j_pt.EpochRule),
        fence_rules=conv(p_pt.FENCE_RULES, j_pt.FenceRule),
        order_rules=conv(p_pt.ORDER_RULES, j_pt.OrderRule),
        ack_rules=conv(p_pt.ACK_RULES, j_pt.AckRule))
    got = p_proto.run(REPO_ROOT)
    assert got[1] == want[1] == 7
    assert norm(got[0]) == norm(want[0]) == []


def test_retrace_table_check_with_the_port_s_table():
    table = tuple(port_of(e, j_jit.JitEntry) for e in p_jit.JIT_TABLE)
    got = p_retrace.check_table(REPO_ROOT)
    assert norm(got) == norm(j_retrace.check_table(REPO_ROOT, table)) == []


# ── row mapping ──────────────────────────────────────────────────────


def test_every_guarded_row_has_its_port_row():
    port = {(s.module, s.cls): s for s in p_locks.GUARDED}
    assert len(port) == len(j_locks.GUARDED)
    for jax_row in j_locks.GUARDED:
        want = rebase_to_port(jax_row, p_locks.GuardSpec)
        got = port[(want.module, want.cls)]
        for lock, attrs in want.locks.items():
            dropped = GUARDED_DEVIATIONS.get((want.cls, lock), set())
            assert set(got.locks[lock]) == set(attrs) - dropped, (
                want.cls, lock)
        assert set(got.locks) == set(want.locks)
        drop = set().union(*GUARDED_DEVIATIONS.values()) \
            if want.cls == "LocalEmbeddings" else set()
        assert set(got.write_only) == set(want.write_only) - drop
        for field in ("holders", "init_only", "hot", "allow_blocking"):
            assert getattr(got, field) == getattr(want, field), field


def test_every_protocol_row_has_its_port_row():
    for name, cls in (("EPOCH_RULES", p_pt.EpochRule),
                      ("FENCE_RULES", p_pt.FenceRule),
                      ("ORDER_RULES", p_pt.OrderRule),
                      ("ACK_RULES", p_pt.AckRule)):
        want = [rebase_to_port(r, cls) for r in getattr(j_pt, name)]
        assert list(getattr(p_pt, name)) == want, name
    assert p_pt.PROTO_MODULES == tuple(
        m.replace(f"{JAX_PKG}/", f"{PORT_PKG}/") for m in j_pt.PROTO_MODULES)
    assert [dataclasses.asdict(c) for c in p_pt.EXPLORER_CONFIGS] == [
        dataclasses.asdict(c) for c in j_pt.EXPLORER_CONFIGS]


def test_every_config_site_has_its_port_row():
    assert p_drift.CONFIG_SITES == tuple(
        (m.replace(f"{JAX_PKG}/", f"{PORT_PKG}/"), *rest)
        for m, *rest in j_drift.CONFIG_SITES)


def test_every_jit_row_has_its_port_row():
    """One port row per JAX row, in the same module (the contents are
    the port's counterparts), plus the build and load sites."""
    def by_module(table, pkg):
        out: dict = {}
        for e in table:
            out.setdefault(e.module.replace(f"{pkg}/", ""), []).append(e)
        return out

    jax_rows = by_module(j_jit.JIT_TABLE, JAX_PKG)
    port_rows = by_module(p_jit.JIT_TABLE, PORT_PKG)
    assert set(port_rows) - set(jax_rows) == {"ops/_build.py"}
    for module, rows in jax_rows.items():
        assert len(port_rows[module]) == len(rows), module
        for jax_row, port_row in zip(rows, port_rows[module]):
            assert port_row.shape_policy == jax_row.shape_policy, module
            assert port_row.entry_names or not jax_row.entry_names, module
    for e in p_jit.JIT_TABLE:
        if e.shape_policy == p_jit.FIXED:
            assert e.rationale.strip(), e.module
        for _m, _f, rationale in e.fixed_callers:
            assert rationale.strip(), e.module


def test_the_table_is_not_blind():
    """Each named per-call body resolves, and the expansion reaches the
    kernels' launch sites."""
    assert p_analysis.tracing.run(REPO_ROOT)[1] == len(p_jit.table_modules())
    for e in p_jit.JIT_TABLE:
        tree = ast.parse((REPO_ROOT / e.module).read_text(encoding="utf-8"))
        included = p_analysis.tracing.expanded_jit_functions(tree, e)
        assert set(e.jit_fns) <= set(included), e.module
        if e.module.endswith(("ops/flash_attention.py",)):
            assert "_launch" in included
        if "levenshtein_rows" in e.jit_fns:
            assert "_launch" in included


# ── the rules with no torch construct, and the gate's own names ────────


def test_shard_donate_has_nothing_to_read_in_the_port():
    """torch has no donate_argnums: no port module declares a donor, so
    GL-SHARD-DONATE can report nothing on the port's tree, though the rule
    id and its fixture check stay."""
    assert "GL-SHARD-DONATE" in p_analysis._PASS_RULES["sharding"]
    for path in sorted((REPO_ROOT / PORT_PKG).rglob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        assert p_sharding._donating_functions(tree) == {}, path
        assert not [n for n in ast.walk(tree)
                    if isinstance(n, ast.keyword)
                    and n.arg == "donate_argnums"], path


def test_the_plans_arm_the_gate_s_rule_table_check(monkeypatch):
    """plan_shardings runs analysis.sharding.validate_rule_table: a table
    whose rule wins on no path fails the placement."""
    from vainplex_openclaw_tpu_torch.parallel import plan
    from vainplex_openclaw_tpu_torch.parallel.mesh import make_mesh

    seen = []
    real = p_sharding.validate_rule_table
    monkeypatch.setattr(p_sharding, "validate_rule_table",
                        lambda *a, **kw: seen.append(a) or real(*a, **kw))
    mesh = make_mesh(axes=("dp",), shape=(1,), devices=["cpu"])
    params = {"w": np.zeros((2, 2), np.float32)}
    dead = dataclasses.replace(plan.PLAN_TABLE["embeddings_forward"],
                               rules=(("nope$", ()), ("", ())))
    with pytest.raises(ValueError, match="matches zero param paths"):
        plan.plan_shardings(dead, params, mesh)
    assert seen


def test_no_jax_package_name_is_left_in_the_gates():
    """A literal naming JAX's package would make the port's gate scan
    JAX's tree and pass."""
    for path in sorted((REPO_ROOT / PORT_PKG / "analysis").glob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert node.value != JAX_PKG, path
                assert not node.value.startswith(f"{JAX_PKG}/"), path
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [
                    getattr(node, "module", None) or ""]
                assert not [n for n in names if n.split(".")[0] in (
                    "jax", "ml_dtypes", JAX_PKG)], path
    assert p_order.run.__defaults__ == (PORT_PKG,)
    assert p_drift.registered_fault_sites.__defaults__ == (PORT_PKG,)
    for mod in (p_jit, p_pt, p_retrace, p_sharding):
        assert mod._PKG == PORT_PKG


def test_wrap_clock_fails_on_the_chosen_tick():
    from vainplex_openclaw_tpu_torch.resilience import (FaultError,
                                                        FaultPlan,
                                                        FaultSpec,
                                                        installed,
                                                        wrap_clock)

    class Clock:
        t = 1_700_000_000.0

        def __call__(self):
            return self.t

    clock = Clock()
    faulty = wrap_clock(clock, site="clock")
    with installed(FaultPlan([FaultSpec("clock", steps=(2,))], seed=0)):
        assert faulty() == clock.t
        with pytest.raises(FaultError):
            faulty()
        assert faulty() == clock.t
    assert faulty() == clock.t   # no plan: a plain clock
