"""The port's fault-injection layer against the JAX package's.

- ``resilience/faults.py``: the same names and fields; one spec list gives
  the same decisions, torn cuts and ``fired`` counts in both packages;
  ``install_plan`` takes any plan by duck typing, so one JAX ``FaultPlan``
  installed in both packages drives one per-site schedule;
- ``save_checkpoint`` under JAX's ``tests/test_checkpoint.py`` crash
  windows (a fault before any rename, between the two renames, and a
  failed save after a good one): the same exception, ``fired`` counts and
  directory listing as JAX's writer, and the same listing after the retry;
- ``write_json_atomic`` under a torn or failed ``file.write``, a failed
  ``file.fsync`` and ``file.rename``: the same exception, counts, listing
  and bytes on disk;
- ``train_loop`` restarted after each fault of one plan on one checkpoint
  directory: the faults, listings and latest steps of JAX's loop under the
  same plan, the schedule ``chip_smoke.chaos_schedule`` computes from the
  plan, and a final state bit-equal to the uninterrupted run's;
- the trace analyzer under a torn cluster-state write and a failed rename
  of the processing state: the exception, the logged error, the files left
  and, after a rerun without the plan, every file equal to JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_trace_analyzer import (CLOCK, CONFIG, TIMING_KEYS,
                                       detector_corpus, log_view)
from test_torch_train import (JCFG, PCFG, _bits_equal, dataset, jax_params,
                              port_flat, port_state)
from vainplex_openclaw_tpu import resilience as jax_res
from vainplex_openclaw_tpu.core.api import list_logger
from vainplex_openclaw_tpu.cortex import trace_analyzer as jta
from vainplex_openclaw_tpu.models import checkpoint as jax_ckpt
from vainplex_openclaw_tpu.models import data as jax_data
from vainplex_openclaw_tpu.models import pretrained as jax_pretrained
from vainplex_openclaw_tpu.models import train as jax_train
from vainplex_openclaw_tpu.resilience import faults as jax_faults
from vainplex_openclaw_tpu.storage import atomic as jax_atomic
from vainplex_openclaw_tpu_torch import resilience as port_res
from vainplex_openclaw_tpu_torch.cortex import trace_analyzer as pta
from vainplex_openclaw_tpu_torch.models import checkpoint as port_ckpt
from vainplex_openclaw_tpu_torch.models import pretrained as port_pretrained
from vainplex_openclaw_tpu_torch.models import train
from vainplex_openclaw_tpu_torch.resilience import faults as port_faults
from vainplex_openclaw_tpu_torch.storage import atomic as port_atomic

PACKAGES = {"jax": jax_res, "port": port_res}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small tensor ops, which stall on a
    thread pool when test workers share the cores: one thread keeps this
    file's time its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_plan_left():
    yield
    jax_faults.clear_plan()
    port_faults.clear_plan()


def plan_of(res, specs, seed=0):
    return res.FaultPlan([res.FaultSpec(*s[:2], **s[2]) if len(s) > 2
                          else res.FaultSpec(*s) for s in specs], seed=seed)


def outcome(fn):
    """``(exception type name, message)`` of ``fn()``, or None."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return type(exc).__name__, str(exc)
    return None


def test_fault_names_and_fields_equal_jax():
    names = ("FaultError", "FaultPlan", "FaultSpec", "active_plan",
             "clear_plan", "install_plan", "installed", "maybe_fail",
             "write_with_faults")
    assert set(names) <= set(port_res.__all__) and set(names) <= set(
        jax_res.__all__)
    assert issubclass(port_res.FaultError, OSError)
    assert [f.name for f in dataclasses.fields(port_res.FaultSpec)] == \
        [f.name for f in dataclasses.fields(jax_res.FaultSpec)]
    assert port_res.FaultSpec("x") == port_res.FaultSpec(
        "x", (), 0.0, "error", "injected fault")


def test_one_spec_list_decides_alike_in_both_packages():
    specs = [("file.*", (2, 5), {"rate": 0.3}),
             ("checkpoint.rename", (3,), {"mode": "torn"}),
             ("transport.publish", (), {"rate": 0.5})]
    plans = {k: plan_of(res, specs, seed=11) for k, res in PACKAGES.items()}
    sites = ["file.write", "file.rename", "checkpoint.rename",
             "transport.publish", "file.write"] * 40
    trace = {k: [(getattr(p.decide(s), "mode", None), p.torn_cut(s, 97))
                 for s in sites] for k, p in plans.items()}
    assert trace["port"] == trace["jax"]
    assert plans["port"].fired == plans["jax"].fired
    assert plans["port"].total_fired() == plans["jax"].total_fired() > 0
    for s in set(sites):
        assert plans["port"].calls(s) == plans["jax"].calls(s)


def test_install_plan_takes_any_plan_by_duck_typing():
    with pytest.raises(TypeError, match="decide"):
        port_faults.install_plan(object())
    plan = jax_res.FaultPlan([jax_res.FaultSpec("x")])
    with port_res.installed(plan) as got:
        assert got is plan and port_faults.active_plan() is plan
    assert port_faults.active_plan() is None


def tree():
    return {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "step": np.asarray(1, np.int32)}


def ckpt_scenario(pkg, d, name):
    """One of JAX's crash windows around ``save_checkpoint`` in ``d``:
    [(outcome, fired, listing)] after the faulted save and after the
    retry."""
    res = PACKAGES[pkg]
    save = (jax_ckpt if pkg == "jax" else port_ckpt).save_checkpoint
    site = "checkpoint.write" if name == "before_rename" else \
        "checkpoint.rename"
    newer = {"w": tree()["w"] + 100.0, "step": np.asarray(2, np.int32)}
    if name == "after_good_save":
        save(d, tree(), step=1)
    plan = plan_of(res, [(site, (1,))])
    step = {"before_rename": 5, "between_renames": 7,
            "after_good_save": 2}[name]
    with res.installed(plan):
        first = outcome(lambda: save(d, newer, step=step))
    out = [(first, dict(plan.fired), sorted(os.listdir(d)))]
    save(d, newer, step=step)
    out.append((None, {}, sorted(os.listdir(d))))
    return out


@pytest.mark.parametrize("name", ["before_rename", "between_renames",
                                  "after_good_save"])
def test_checkpoint_crash_windows_equal_jax(tmp_path, name):
    got = ckpt_scenario("port", str(tmp_path / "port"), name)
    want = ckpt_scenario("jax", str(tmp_path / "jax"), name)
    assert got == want
    (exc, fired, listing), (_, _, after) = got
    assert exc[0] == "FaultError" and sum(fired.values()) == 1
    assert not [f for f in listing + after if f.endswith(".tmp")]
    before = {"before_rename": [], "after_good_save": [1],
              "between_renames": []}[name]
    # a visible step always has its manifest; an orphan manifest is inert
    assert [f for f in listing if f.endswith(".npz")] == \
        [f"step-{s}.npz" for s in before]
    if name == "between_renames":
        assert listing == ["step-7.manifest.json"]
    step = {"before_rename": 5, "between_renames": 7, "after_good_save": 2}
    assert port_ckpt.latest_step(str(tmp_path / "port")) == step[name]


@pytest.mark.parametrize("fault", [
    ("file.write", (1,), {"mode": "torn"}), ("file.write", (1,)),
    ("file.fsync", (1,)), ("file.rename", (1,))],
    ids=["torn_write", "write", "fsync", "rename"])
def test_atomic_writer_faults_equal_jax(tmp_path, fault):
    """A faulted overwrite of a live file: the same exception (a torn
    write's cut included), counts, listing and bytes; the live file keeps
    its old bytes and no tmp file is left."""
    obj = {"a": list(range(50)), "b": "ü" * 20}
    out = {}
    for pkg, writer in (("jax", jax_atomic), ("port", port_atomic)):
        d = tmp_path / pkg
        path = d / "state.json"
        writer.write_json_atomic(path, {"old": True})
        plan = plan_of(PACKAGES[pkg], [fault])
        with PACKAGES[pkg].installed(plan):
            exc = outcome(lambda: writer.write_json_atomic(path, obj,
                                                           durable=True))
        out[pkg] = (exc, dict(plan.fired), sorted(os.listdir(d)),
                    path.read_bytes())
    assert out["port"] == out["jax"]
    exc, fired, listing, data = out["port"]
    assert exc[0] == "FaultError" and fired == {fault[0]: 1}
    assert listing == ["state.json"] and json.loads(data) == {"old": True}


def test_one_jax_plan_drives_both_packages_writers(tmp_path):
    """One JAX plan installed in both packages: the JAX and the port
    writers share its per-site counts, so its 2nd and 3rd calls fault
    whichever package makes them."""
    plan = jax_res.FaultPlan([
        jax_res.FaultSpec("checkpoint.write", steps=(2,)),
        jax_res.FaultSpec("file.write", steps=(3,), mode="torn")], seed=5)
    jax_faults.install_plan(plan)
    port_faults.install_plan(plan)
    jax_ckpt.save_checkpoint(str(tmp_path / "a"), tree(), step=1)
    with pytest.raises(port_res.FaultError, match="checkpoint.write"):
        port_ckpt.save_checkpoint(str(tmp_path / "b"), tree(), step=1)
    port_atomic.write_json_atomic(tmp_path / "c.json", {"x": 1})
    jax_atomic.write_json_atomic(tmp_path / "d.json", {"x": 2})
    with pytest.raises(port_res.FaultError, match="torn write"):
        port_atomic.write_json_atomic(tmp_path / "e.json", {"x": 3})
    assert plan.calls("checkpoint.write") == 2 and plan.calls("file.write") == 3
    assert plan.fired == {"checkpoint.write": 1, "file.write": 1}
    assert sorted(os.listdir(tmp_path)) == ["a", "b", "c.json", "d.json"]
    assert os.listdir(tmp_path / "b") == []


FAULTS = (("checkpoint.write", 2), ("checkpoint.rename", 4))
TOTAL, SAVE_EVERY = 7, 2


def chaos_runs(pkg, ckpt_dir) -> tuple:
    """``train_loop`` to ``TOTAL`` restarted on ``ckpt_dir`` after each
    fault of ``FAULTS``: [(fault message, listing, latest step)] per run,
    the plan's fired counts and the last state."""
    res = PACKAGES[pkg]
    plan = plan_of(res, [(site, (n,)) for site, n in FAULTS])
    runs = []
    with res.installed(plan):
        for _ in range(len(FAULTS) + 1):
            try:
                if pkg == "jax":
                    opt = jax_train.make_optimizer()
                    state = jax_train.train_loop(
                        jax_train.init_state(jax_params(), opt),
                        dataset(lib=jax_data), JCFG, opt, total_steps=TOTAL,
                        ckpt_dir=ckpt_dir, save_every=SAVE_EVERY)
                else:
                    state = train.train_loop(
                        port_state(jax_params()), dataset(), PCFG,
                        total_steps=TOTAL, ckpt_dir=ckpt_dir,
                        save_every=SAVE_EVERY)
                fault = None
            except res.FaultError as exc:
                fault = str(exc)
            latest = (jax_ckpt if pkg == "jax" else port_ckpt).latest_step(
                ckpt_dir)
            runs.append((fault, sorted(os.listdir(ckpt_dir)), latest))
            if fault is None:
                return runs, dict(plan.fired), state
    raise AssertionError(f"{pkg}: still faulting after {runs}")


def test_train_loop_restarted_after_faults_equals_jax_and_straight(tmp_path):
    got, fired, state = chaos_runs("port", str(tmp_path / "port"))
    want, jax_fired, _ = chaos_runs("jax", str(tmp_path / "jax"))
    assert got == want and fired == jax_fired == {
        "checkpoint.write": 1, "checkpoint.rename": 1}
    schedule = chip_smoke.chaos_schedule(TOTAL, SAVE_EVERY, FAULTS)
    assert [r[0] and r[0][len("[fault:"):r[0].index("]")] for r in got] == \
        [r["fault"] for r in schedule["runs"]]
    assert [r[2] for r in got] == [r["latest"] for r in schedule["runs"]]
    for _, listing, _ in got:
        assert not [f for f in listing if f.endswith(".tmp")]
        steps = [f[5:-4] for f in listing if f.endswith(".npz")]
        assert all(f"step-{s}.manifest.json" in listing for s in steps)
    straight = train.train_loop(port_state(jax_params()), dataset(), PCFG,
                                total_steps=TOTAL)
    assert state.step == straight.step == TOTAL
    assert _bits_equal(port_flat(state.to_tree()),
                       port_flat(straight.to_tree()))


def test_chaos_schedule_counts_the_steps_a_plan_replays():
    """The chaos phase's host formula: at 60 steps saved every 10, a
    failed 2nd write and a failed 4th rename cost 20 replayed steps."""
    s = chip_smoke.chaos_schedule(60, 10, chip_smoke.CHAOS_TRAIN_FAULTS)
    assert s["runs"] == [
        {"from": 0, "to": 20, "fault": "checkpoint.write", "latest": 10},
        {"from": 10, "to": 40, "fault": "checkpoint.rename", "latest": 30},
        {"from": 30, "to": 60, "fault": None, "latest": 60}]
    assert (s["steps"], s["replayed"]) == (80, 20)
    assert chip_smoke.chaos_schedule(60, 10, ()) == {
        "runs": [{"from": 0, "to": 60, "fault": None, "latest": 60}],
        "steps": 60, "replayed": 0}


def analyzer_files(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        data = (d / name).read_bytes()
        if name == jta.report.REPORT_FILE:
            rep = json.loads(data)
            for key in TIMING_KEYS:
                rep["runStats"].pop(key)
            data = json.dumps(rep)
        out[name] = data
    return out


def test_trace_analyzer_under_the_chaos_plan_equals_jax(tmp_path):
    """``chip_smoke.CHAOS_TRACE_FAULTS``: the torn cluster-state write is
    caught and logged, the processing state's rename fails the run; then a
    rerun without a plan. Exception, log, files left and files after the
    rerun equal JAX's."""
    raws = detector_corpus(seed=7)
    out = {}
    jax_pretrained.clear_cache()
    port_pretrained.clear_cache()
    for pkg, ta, kw in (("port", pta, {"device": "cpu"}), ("jax", jta, {})):
        d = tmp_path / pkg
        plan = plan_of(PACKAGES[pkg], [
            (site, (n,), {"mode": mode})
            for site, n, mode in chip_smoke.CHAOS_TRACE_FAULTS])
        log = list_logger()

        def run(log=log):
            return ta.TraceAnalyzer(CONFIG, d, log,
                                    source=ta.MemoryTraceSource(raws),
                                    clock=lambda: CLOCK, **kw).run()

        with PACKAGES[pkg].installed(plan):
            exc = outcome(run)
        left = analyzer_files(d)
        run(list_logger())
        out[pkg] = (exc, dict(plan.fired), log_view(log.records), left,
                    analyzer_files(d))
    assert out["port"] == out["jax"]
    exc, fired, log, left, after = out["port"]
    assert exc[0] == "FaultError" and "file.rename" in exc[1]
    assert fired == {"file.write": 1, "file.rename": 1}
    assert any("failure clustering failed" in m and "torn write" in m
               for lv, m in log if lv == "error")
    assert list(left) == [jta.report.REPORT_FILE]
    assert sorted(after) == sorted([jta.report.REPORT_FILE,
                                    jta.report.STATE_FILE,
                                    jta.clusters.CLUSTER_STATE_FILE])
