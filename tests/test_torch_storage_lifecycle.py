"""The port's grown ``storage/lifecycle.py``, ``storage/workspace.py`` and
``storage/atomic.py``'s ``Debouncer`` and ``AtomicStorage`` against the JAX
package's.

``LifecycleManager`` in the settings form both packages share, on one
seeded script per case (register with owners, traffic past the resident
cap and the idle horizon, ``idle_victims``, hibernation whose callback
flushes a workspace journal and ships its snapshot, callbacks that fail
with ``OSError``, wakes, per-workspace timers): the same victims, flags,
keys and ``stats()`` at every step, less the wall times, and the journals'
files byte-equal. ``lifecycle_settings`` on the config shapes both accept.
The int form (``LifecycleManager(n)``) that the port keeps for its model
registry equals ``{"maxResident": n, "idleSeconds": 0.0}``.
"""

from __future__ import annotations

import gzip
import random

import pytest

from helpers import FakeClock
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.storage import atomic as jax_atomic
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu.storage import lifecycle as jax_lifecycle
from vainplex_openclaw_tpu.storage import workspace as jax_workspace
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.storage import atomic as port_atomic
from vainplex_openclaw_tpu_torch.storage import journal as port_journal
from vainplex_openclaw_tpu_torch.storage import lifecycle as port_lifecycle
from vainplex_openclaw_tpu_torch.storage import workspace as port_workspace

PORT = dict(api=port_api, lifecycle=port_lifecycle, journal=port_journal,
            atomic=port_atomic)
JAX = dict(api=jax_api, lifecycle=jax_lifecycle, journal=jax_journal,
           atomic=jax_atomic)
WALL = ("wakeP50Ms", "wakeP99Ms")


def untimed(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in WALL}


def test_defaults_and_settings_are_jax_s():
    assert port_lifecycle.LIFECYCLE_DEFAULTS == \
        jax_lifecycle.LIFECYCLE_DEFAULTS
    for config in (None, {}, {"storage": {}}, {"storage": {"lifecycle": False}},
                   {"storage": {"lifecycle": True}},
                   {"storage": {"lifecycle": {"maxResident": 3,
                                              "idleSeconds": 60,
                                              "bogus": 1}}},
                   {"storage": {"lifecycle": {"enabled": False}}}):
        for default in (True, False):
            assert port_lifecycle.lifecycle_settings(config, default) == \
                jax_lifecycle.lifecycle_settings(config, default)


def test_the_int_form_is_the_lru_settings():
    for n in (1, 3, 40):
        a = port_lifecycle.LifecycleManager(n)
        b = port_lifecycle.LifecycleManager({"maxResident": n,
                                             "idleSeconds": 0.0})
        assert a.settings == b.settings and a.stats() == b.stats()


def lifecycle_run(pkg, root, script, settings) -> tuple:
    """Drive ``script`` through one manager whose owners each flush and
    ship a workspace journal at hibernation, as the cortex plugin's do."""
    clock = FakeClock(1_700_000_000.0)
    log = pkg["api"].list_logger()
    mgr = pkg["lifecycle"].LifecycleManager(settings, clock=clock,
                                            logger=log)
    ls = pkg["lifecycle"].lifecycle_settings(
        {"storage": {"lifecycle": {**settings, "shipEveryRecords": 4,
                                   "maxSegmentBytes": 600}}})
    js = pkg["journal"].journal_settings({"storage": {"journal": {
        "maxSegmentBytes": 600}}})
    journals = {}
    failing = set()

    def journal(ws):
        j = journals.get(ws)
        if j is None or j._closed:
            j = journals[ws] = pkg["journal"].get_journal(
                str(root / ws), js, clock=clock, wall=False, logger=log,
                lifecycle=ls, lifecycle_timer=mgr.timer_for(ws))
            j.register_snapshot("state", root / ws / "state.json",
                                indent=None)
        return j

    def hibernate(ws):
        if ws in failing:
            raise OSError(f"disk full under {ws}")
        j = journal(ws)
        j.ship_snapshot()
        j.close()

    out = []
    for op in script:
        kind, ws = op[0], op[1]
        clock.advance(op[2])
        if kind == "register":
            mgr.register(ws, lambda w=ws: hibernate(w), owner=op[3])
            res = None
        elif kind == "traffic":
            if mgr.is_sleeping(ws):
                mgr.note_wake(ws, 1.0)
            j = journal(ws)
            j.append("state", {"ws": ws, "n": op[3], "pad": "x" * 60})
            j.commit()
            victims = mgr.note_traffic(ws)
            res = (victims, [mgr.hibernate(v) for v in victims])
        elif kind == "idle":
            victims = mgr.idle_victims()
            res = (victims, [mgr.hibernate(v) for v in victims])
        elif kind == "fail":
            failing.symmetric_difference_update({ws})
            res = sorted(failing)
        else:
            res = mgr.hibernate(ws)
        out.append((res, mgr.is_sleeping(ws), mgr.resident_keys(),
                    mgr.sleeping_keys(), untimed(mgr.stats())))
    for j in journals.values():
        j.close()
    pkg["journal"].reset_journals()
    files = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            files[str(p.relative_to(root))] = (gzip.decompress(data)
                                               if p.suffix == ".gz" else data)
    stages = sorted(mgr.timer.stages_ms())
    return out, files, stages, log.records


def lifecycle_script(seed: int, n: int = 220) -> list:
    rng = random.Random(f"storage-lifecycle:{seed}")
    script = []
    for i in range(n):
        ws = f"ws{rng.randrange(7)}"
        dt = rng.choice([0.5, 2.0, 20.0, 75.0])
        r = rng.random()
        if r < 0.15:
            script.append(("register", ws, dt, rng.choice(["a", "b"])))
        elif r < 0.75:
            script.append(("traffic", ws, dt, i))
        elif r < 0.85:
            script.append(("idle", ws, dt))
        elif r < 0.9:
            script.append(("fail", ws, dt))
        else:
            script.append(("hibernate", ws, dt))
    return script


@pytest.mark.parametrize("seed,settings", [
    (0, {"maxResident": 3, "idleSeconds": 0.0}),
    (1, {"maxResident": 4, "idleSeconds": 120.0}),
    (2, {"maxResident": 2, "idleSeconds": 30.0})])
def test_lifecycle_manager_equals_jax(tmp_path, seed, settings):
    script = lifecycle_script(seed)
    got = lifecycle_run(PORT, tmp_path / "port", script, settings)
    want = lifecycle_run(JAX, tmp_path / "jax", script, settings)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, (i, script[i])
    assert got[1:] == want[1:]
    final = want[0][-1][-1]
    assert final["evictions"] > 0 and final["wakes"] > 0
    assert final["hibernateFailures"] > 0
    assert "snapshot" in want[2]  # shipping timed into the aggregate
    assert any(name.endswith("journal.meta.json") for name in want[1])


def test_timer_for_is_absorbed_at_hibernation():
    for pkg in (PORT, JAX):
        mgr = pkg["lifecycle"].LifecycleManager({"maxResident": 1},
                                                clock=FakeClock())
        mgr.register("a", lambda: None)
        mgr.timer_for("a").add("snapshot", 2.0)
        assert mgr.timer_for("a") is mgr.timer_for("a")
        assert mgr.hibernate("a")
        assert mgr.timer.stages_ms() == {"snapshot": 2.0}


# ── workspace, Debouncer, AtomicStorage ──────────────────────────────


def test_workspace_helpers_equal_jax(tmp_path):
    (tmp_path / "old.txt").write_text("x")
    ro = tmp_path / "ro"
    ro.mkdir()
    ro.chmod(0o500)
    try:
        for fn, args in (("reboot_dir", (tmp_path,)),
                         ("is_writable", (tmp_path / "new" / "dir",)),
                         ("is_writable", (ro / "sub",)),
                         ("is_file_older_than", (tmp_path / "old.txt", 1.0)),
                         ("is_file_older_than", (tmp_path / "old.txt", 1.0,
                                                 4e9)),
                         ("is_file_older_than", (tmp_path / "none", 1.0))):
            assert getattr(port_workspace, fn)(*args) == \
                getattr(jax_workspace, fn)(*args), fn
    finally:
        ro.chmod(0o700)


def atomic_run(pkg, root, journal: bool) -> tuple:
    clock = FakeClock(1_700_000_000.0)
    log = pkg["api"].list_logger()
    j = (pkg["journal"].get_journal(
        str(root), pkg["journal"].journal_settings({}), clock=clock,
        wall=False, logger=log) if journal else None)
    store = pkg["atomic"].AtomicStorage(root / "kv", wall=False, journal=j)
    state = {"n": 0}
    fired = []
    deb = pkg["atomic"].Debouncer(lambda: fired.append(state["n"]), 15.0,
                                  wall=False)
    out = [store.load("a.json", {"empty": True})]
    for i in range(12):
        state["n"] = i
        store.save("a.json", {"i": i, "items": list(range(i))})
        store.save_debounced("b.json", lambda: dict(state), delay_s=15.0)
        deb.trigger()
        out.append((deb.pending, store.load("a.json")))
        if i % 4 == 3:
            deb.flush()
            store.flush_all()
            out.append(store.load("b.json"))
    deb.stop()
    store.stop()
    out.append((fired, deb.pending, store.load("b.json"),
                store.path("a.json").name))
    pkg["journal"].reset_journals()
    files = {str(p.relative_to(root)): p.read_bytes()
             for p in sorted(root.rglob("*")) if p.is_file()
             and not p.name.startswith("wal.")}
    return out, files


@pytest.mark.parametrize("journal", [False, True], ids=["legacy", "journal"])
def test_debouncer_and_atomic_storage_equal_jax(tmp_path, journal):
    got = atomic_run(PORT, tmp_path / "port", journal)
    want = atomic_run(JAX, tmp_path / "jax", journal)
    assert got == want
    assert want[0][-1][0] == [3, 7, 11]
    assert "kv/b.json" in want[1]
