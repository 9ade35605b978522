"""The port's model registry and its LifecycleManager copy against the JAX
package.

- Settings: ``REGISTRY_DEFAULTS`` and ``registry_settings`` equal JAX's
  for bool, dict and None sections.
- The version book: the cases of ``tests/test_model_lifecycle.py``'s
  ``TestRegistryBook`` on the port's registry, and 1000-resolve canary
  sequences at fractions 0, 0.1, 1/3, 0.5 and 1.0 equal element for
  element to JAX's.
- ``LifecycleManager``: one sequence of register / note_traffic /
  hibernate / note_wake through both copies (LRU cap set, idle eviction
  off, as the registry runs it) gives the same victims and ``stats()`` at
  every step, and the same bounded set of sleeping keys.
- Paging: evict and wake on twin checkpoints (the port on ``device="cpu"``)
  flip the same flags and counters as JAX's, and a woken tree serves the
  same verdicts; ``stats()`` equals JAX's after the same operations,
  timing fields aside.
- Promotion: on twin checkpoints written as
  ``tests/test_model_lifecycle.py::twin_checkpoints`` writes them (bf16),
  ``verdictRegressions`` equal to JAX's for the identical twin (0) and the
  negated severity head (every text), and the bench leg refuses at
  ``benchFactor`` 1e-9.
"""

from __future__ import annotations

import json
import os
import random

import pytest
import torch

from vainplex_openclaw_tpu.models import registry as jax_registry
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.slo.workload import generate_serve_texts
from vainplex_openclaw_tpu.storage import lifecycle as jax_lifecycle
from vainplex_openclaw_tpu_torch.models import registry
from vainplex_openclaw_tpu_torch.models import serve
from vainplex_openclaw_tpu_torch.parallel import plan
from vainplex_openclaw_tpu_torch.storage import lifecycle

TIMING = ("wakeP50Ms", "wakeP99Ms")


@pytest.fixture(autouse=True)
def _clean_registries():
    """Registries book themselves process-wide; a leaked one would show up
    in every later registry listing (and JAX's /ops collector)."""
    yield
    registry.clear_registries()
    jax_registry.clear_registries()


def twin_checkpoints(tmp_path, same_weights: bool = True,
                     dtype: str = "bfloat16", seed: int = 0):
    """``tests/test_model_lifecycle.py::twin_checkpoints``: two
    same-architecture checkpoint dirs, identical weights or a negated
    severity head (argmax → argmin on every input). ``dtype="float32"``
    writes the same weights as an fp32 model, whose verdicts the two
    packages give identically (bf16 noise can flip a near-tie)."""
    import bench
    import jax
    from vainplex_openclaw_tpu.models.checkpoint import save_checkpoint
    from vainplex_openclaw_tpu.models.encoder import EncoderConfig, init_params
    from vainplex_openclaw_tpu.models.pretrained import _config_to_manifest

    cfg = EncoderConfig(vocab_size=512, seq_len=64, d_model=32, n_heads=2,
                        n_layers=2, d_ff=64, attn_impl="dense", dtype=dtype)
    dir_a = str(tmp_path / f"ckpt-v1-{dtype}")
    dir_b = str(tmp_path / f"ckpt-v2-{dtype}-{same_weights}")
    bench.write_serving_checkpoint(dir_a, cfg, seed=seed)
    params = init_params(jax.random.PRNGKey(seed), cfg)
    if not same_weights:
        params["heads"]["severity"] = -params["heads"]["severity"]
    save_checkpoint(dir_b, params, step=1)
    with open(os.path.join(dir_b, "config.json"), "w", encoding="utf-8") as f:
        json.dump({"config": _config_to_manifest(cfg), "eval": {}}, f)
    return cfg, dir_a, dir_b


def port_registry(name, **settings):
    return registry.ModelRegistry({"enabled": True, **settings}, name=name,
                                  device="cpu")


def jax_registry_of(name, **settings):
    return jax_registry.ModelRegistry({"enabled": True, **settings},
                                      name=name)


def stub_pair(name, versions=("v1", "v2", "v3"), **settings):
    """The same stub book in both packages."""
    regs = (port_registry(name, **settings),
            jax_registry_of(name, **settings))
    for reg in regs:
        for i, v in enumerate(versions):
            reg.register_stub(v, activate=(i == 0))
    return regs


def untimed(stats: dict) -> dict:
    out = json.loads(json.dumps(stats))
    for k in TIMING:
        out["paging"].pop(k)
    return out


# ── settings ────────────────────────────────────────────────────────


SECTIONS = [None, True, False, {}, {"maxResidentVersions": 2},
            {"enabled": False, "benchFactor": 2.0}, {"bogus": 1},
            {"canaryFraction": 0.25, "shadowWindow": 0}]


@pytest.mark.parametrize("default_enabled", [False, True])
@pytest.mark.parametrize("raw", SECTIONS, ids=repr)
def test_registry_settings_equal_jax(raw, default_enabled):
    assert registry.REGISTRY_DEFAULTS == jax_registry.REGISTRY_DEFAULTS
    assert registry.registry_settings(raw, default_enabled) == \
        jax_registry.registry_settings(raw, default_enabled)


@pytest.mark.parametrize("raw", SECTIONS, ids=repr)
def test_constructor_settings_equal_jax(raw):
    a = registry.ModelRegistry(raw, name="cfg", device="cpu")
    b = jax_registry.ModelRegistry(raw, name="cfg")
    assert a.settings == b.settings
    assert untimed(a.stats()) == untimed(b.stats())


def test_serve_defaults_carry_the_flag_off():
    assert serve.SERVE_DEFAULTS["modelRegistry"] is False
    assert serve.SERVE_DEFAULTS == jax_serve.SERVE_DEFAULTS


def test_registry_defaults_to_the_card_and_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.ModelRegistry({"enabled": True}, name="card")


# ── the version book (TestRegistryBook on the port) ─────────────────


class TestRegistryBook:
    def test_first_registration_bootstraps_active(self):
        reg, _ = stub_pair("book-1")
        assert reg.active() == "v1"
        assert reg.versions() == ["v1", "v2", "v3"]
        assert reg.rollback_target() is None
        assert reg.has("v2") and not reg.has("v9")

    def test_duplicate_version_refused(self):
        reg, _ = stub_pair("book-2", versions=("v1",))
        with pytest.raises(ValueError, match="already registered"):
            reg.register_stub("v1")

    def test_missing_checkpoint_is_loud(self, tmp_path):
        reg = port_registry("book-3")
        with pytest.raises(RuntimeError, match="no trained checkpoint"):
            reg.register("v1", str(tmp_path / "nowhere"))

    def test_resolution_order_pin_canary_active(self):
        reg, _ = stub_pair("book-4")
        assert reg.resolve("t0") == "v1"
        reg.set_canary("v2", 1.0)
        assert reg.resolve("t0") == "v2"
        reg.pin("t0", "v3")
        assert reg.resolve("t0") == "v3"   # pin beats canary
        assert reg.resolve("t1") == "v2"
        reg.unpin("t0")
        reg.clear_canary()
        assert reg.resolve("t0") == "v1"

    @pytest.mark.parametrize("fraction", [0.25, 0.5, 0.1])
    def test_canary_split_exact_and_reproducible(self, fraction):
        def run():
            reg, _ = stub_pair(f"book-split-{fraction}")
            reg.set_canary("v2", fraction)
            return [reg.resolve("t") for _ in range(40)]

        a, b = run(), run()
        assert a == b
        assert a.count("v2") == int(40 * fraction)

    def test_activate_tracks_rollback_and_counts(self):
        reg, _ = stub_pair("book-5")
        reg.activate("v2")
        assert (reg.active(), reg.rollback_target()) == ("v2", "v1")
        assert reg.stats()["swaps"] == 1
        reg.activate(reg.rollback_target())
        assert reg.active() == "v1"
        st = reg.stats()
        assert st["swaps"] == 2 and st["rollbacks"] == 1
        assert st["versions"]["v2"]["state"] == "standby"

    def test_unknown_versions_raise_key_error(self):
        reg, _ = stub_pair("book-unknown")
        for verb in (lambda: reg.activate("v9"),
                     lambda: reg.set_canary("v9", 0.5),
                     lambda: reg.pin("t", "v9"),
                     lambda: reg.checkout("v9"),
                     lambda: reg.placement_key("v9")):
            with pytest.raises(KeyError, match="unknown model version"):
                verb()

    def test_stub_checkout_refused(self):
        reg, _ = stub_pair("book-6")
        with pytest.raises(RuntimeError, match="sim stub"):
            reg.checkout("v1")
        assert reg.is_stub("v1") and not reg.is_stub("v9")

    def test_placement_keys_distinct_per_version(self, tmp_path):
        """Twin versions from ONE directory get distinct placement keys
        (JAX's own keys) and host trees of their own."""
        _, dir_a, _ = twin_checkpoints(tmp_path, dtype="float32")
        reg = port_registry("book-7")
        jreg = jax_registry_of("book-7")
        for r in (reg, jreg):
            r.register("a", dir_a, activate=True)
            r.register("b", dir_a)
        assert reg.placement_key("a") != reg.placement_key("b")
        assert reg.placement_key("a").startswith(os.path.abspath(dir_a))
        for v in ("a", "b"):
            assert reg.placement_key(v) == jreg.placement_key(v)
        wa = reg._versions["a"].params["embed"]["tok"]
        wb = reg._versions["b"].params["embed"]["tok"]
        assert wa is not wb and wa.data_ptr() != wb.data_ptr()
        assert torch.equal(wa, wb)

    def test_note_served_counts_per_version(self):
        reg, jreg = stub_pair("book-served")
        for r in (reg, jreg):
            r.note_served("v2", 3)
            r.note_served("v9", 5)      # unknown: ignored, as JAX
        assert untimed(reg.stats()) == untimed(jreg.stats())
        assert reg.stats()["versions"]["v2"]["served"] == 3


@pytest.mark.parametrize("fraction", [0.0, 0.1, 1 / 3, 0.5, 1.0],
                         ids=["0", "0.1", "1/3", "0.5", "1"])
def test_resolution_sequences_equal_jax(fraction):
    """1000 resolutions across three tenants, one pinned half-way, with
    the canary armed: element for element the JAX registry's."""
    seqs = []
    for reg in stub_pair(f"resolve-{fraction}"):
        reg.set_canary("v2", fraction)
        out = []
        for n in range(1000):
            if n == 500:
                reg.pin("t1", "v3")
            out.append(reg.resolve(f"t{n % 3}"))
        seqs.append(out)
    assert seqs[0] == seqs[1]
    if 0 < fraction < 1:
        assert 0 < seqs[0].count("v2") < 1000


# ── the LifecycleManager copy ───────────────────────────────────────


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def manager_pair(max_resident):
    """The port's manager and JAX's, as the registry configures them: an
    LRU cap and no idle horizon, each on its own clock."""
    out = []
    for make in (lambda c: lifecycle.LifecycleManager(max_resident, clock=c),
                 lambda c: jax_lifecycle.LifecycleManager(
                     {"maxResident": max_resident, "idleSeconds": 0.0},
                     clock=c)):
        clock = Clock()
        out.append((make(clock), clock))
    return out


def same_stats(port, jax_mgr):
    """The port's stats are the JAX keys the registry reads."""
    theirs = jax_mgr.stats()
    return port.stats() == {k: theirs[k] for k in port.stats()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lifecycle_manager_copy_equals_jax(seed):
    """One seeded sequence of register / note_traffic / hibernate /
    note_wake through both managers: the same victims, flags and stats at
    every step."""
    managers = manager_pair(3)
    rng = random.Random(f"lifecycle:{seed}")
    dropped = {0: [], 1: []}
    for step in range(300):
        r = rng.random()
        ws = f"ws{rng.randrange(8)}"
        dt = rng.choice([0.5, 1.0, 2.5])
        ms = rng.choice([0.1, 1.5, 7.0])
        outs = []
        for i, (mgr, clock) in enumerate(managers):
            clock.t += dt
            if r < 0.3:
                mgr.register(ws, lambda i=i, ws=ws: dropped[i].append(ws))
                out = None
            elif r < 0.75:
                victims = mgr.note_traffic(ws)
                out = (victims, [mgr.hibernate(v) for v in victims])
            elif r < 0.88:
                out = mgr.hibernate(ws)
            else:
                mgr.note_wake(ws, ms)
                out = None
            outs.append((out, mgr.is_sleeping(ws), mgr.resident_keys(),
                         mgr.sleeping_keys()))
        assert outs[0] == outs[1], f"step {step}"
        assert same_stats(managers[0][0], managers[1][0]), f"step {step}"
    assert dropped[0] == dropped[1]
    assert managers[0][0].stats()["evictions"] > 0


@pytest.mark.parametrize("max_resident", [1, 5])
def test_lifecycle_manager_sleep_markers_bounded_like_jax(max_resident):
    """Past ``max(64, 16 × maxResident)`` sleepers the oldest marker goes,
    in both copies alike."""
    managers = manager_pair(max_resident)
    for n in range(200):
        for mgr, clock in managers:
            clock.t += 1.0
            mgr.register(f"k{n:03d}", lambda: None)
            for victim in mgr.note_traffic(f"k{n:03d}"):
                mgr.hibernate(victim)
    port, theirs = managers[0][0], managers[1][0]
    assert port.sleeping_keys() == theirs.sleeping_keys()
    assert len(port.sleeping_keys()) == max(64, 16 * max_resident)
    assert same_stats(port, theirs)


# ── paging ──────────────────────────────────────────────────────────


def verdict_pair(tmp_path, name, **settings):
    _, dir_a, dir_b = twin_checkpoints(tmp_path, same_weights=False,
                                       dtype="float32")
    regs = (port_registry(name, **settings),
            jax_registry_of(name, **settings))
    for r in regs:
        r.register("v1", dir_a, activate=True)
        r.register("v2", dir_b)
    return regs


def test_paging_evicts_and_wakes_like_jax(tmp_path):
    reg, jreg = verdict_pair(tmp_path, "paging", maxResidentVersions=1)
    texts = generate_serve_texts(3, 9)
    before = reg._score("v1", texts)
    trail = []
    for r in (reg, jreg):
        flags = []
        for v in ("v1", "v2", "v1", "v2", "v1"):
            r.checkout(v)
            flags.append((r.is_paged("v1"), r.is_paged("v2")))
        trail.append(flags)
    assert trail[0] == trail[1]
    assert trail[0][-1] == (False, True)
    st, jst = reg.stats()["paging"], jreg.stats()["paging"]
    assert (st["wakes"], st["evictions"]) == (jst["wakes"], jst["evictions"])
    assert st["wakes"] >= 3 and st["wakeP99Ms"] is not None
    # the evicted version's device tree is gone from the registry, and a
    # wake re-registered its dropper (every alternation evicted again)
    assert set(reg._placed) == {"v1"}
    assert reg._score("v1", texts) == before == jreg._score("v1", texts)
    assert reg._score("v2", texts) == jreg._score("v2", texts) != before


def test_eviction_drops_the_placement_cache_entries(tmp_path):
    reg, _ = verdict_pair(tmp_path, "paging-cache", maxResidentVersions=1)
    _, params, key = reg.checkout("v1")
    with plan._sharded_lock:
        plan._sharded_params[(key, "mesh", "plan")] = (params, object())
        plan._sharded_params[("other", "mesh", "plan")] = (params, object())
    try:
        del params
        reg.checkout("v2")              # evicts v1
        with plan._sharded_lock:
            keys = [ck[0] for ck in plan._sharded_params]
        assert key not in keys and "other" in keys
    finally:
        plan.drop_sharded_params("other")


def test_stats_equal_jax_after_the_same_operations(tmp_path):
    """Book, canary, pins, swaps, shadow ring, serving and paging through
    both registries: the same stats(), timing fields aside."""
    reg, jreg = verdict_pair(tmp_path, "stats", maxResidentVersions=1,
                             shadowWindow=4)
    for r in (reg, jreg):
        r.register_stub("sim")
        r.set_canary("v2", 1 / 3)
        r.pin("t9", "sim")
        for i in range(7):
            r.resolve(f"t{i % 2}")
            r.shadow_note(f"text {i}")
        r.checkout("v1")
        r.checkout("v2")
        r.note_served("v2", 4)
        r.activate("v2")
        r.activate(r.rollback_target())
        r.unpin("t9")
    assert untimed(reg.stats()) == untimed(jreg.stats())
    assert reg.shadow_texts() == jreg.shadow_texts() == \
        [f"text {i}" for i in range(3, 7)]


# ── promotion gate ──────────────────────────────────────────────────


def promotion_pair(tmp_path, same_weights, **settings):
    _, dir_a, dir_b = twin_checkpoints(tmp_path, same_weights=same_weights)
    regs = (port_registry("promo", **settings),
            jax_registry_of("promo", **settings))
    for r in regs:
        r.register("v1", dir_a, activate=True)
        r.register("v2", dir_b)
    return regs


def test_identical_twin_promotes_like_jax(tmp_path):
    reg, jreg = promotion_pair(tmp_path, True, benchRounds=1,
                               benchFactor=4.0)
    texts = generate_serve_texts(0, 12)
    report = reg.promotion_report("v2", texts=texts)
    want = jreg.promotion_report("v2", texts=texts)
    assert report["verdictRegressions"] == want["verdictRegressions"] == 0
    assert report["replayed"] == want["replayed"] == 12
    assert set(report) == set(want)
    assert reg.promote("v2", report=report)["promote"] is True
    assert reg.stats()["promotions"] == 1


def test_verdict_regression_refuses_loudly_like_jax(tmp_path):
    reg, jreg = promotion_pair(tmp_path, False, benchRounds=1)
    texts = generate_serve_texts(0, 12)
    report = reg.promotion_report("v2", texts=texts)
    want = jreg.promotion_report("v2", texts=texts)
    # the negated severity head flips argmax → argmin on EVERY text
    assert report["verdictRegressions"] == want["verdictRegressions"] == 12
    assert report["promote"] is False
    with pytest.raises(RuntimeError, match="promotion gate refused"):
        reg.promote("v2", report=report)
    assert reg.stats()["promotions"] == 0


def test_bench_leg_refuses_slow_candidate(tmp_path):
    reg, _ = promotion_pair(tmp_path, True, benchRounds=1, benchFactor=1e-9)
    report = reg.promotion_report("v2", texts=generate_serve_texts(0, 8))
    assert report["verdictRegressions"] == 0
    assert report["benchOk"] is False and report["promote"] is False
    assert report["candidateP50Ms"] > 0 and report["incumbentP50Ms"] > 0


def test_promotion_replays_the_shadow_ring(tmp_path):
    reg, jreg = promotion_pair(tmp_path, False, benchRounds=1)
    for r in (reg, jreg):
        for t in generate_serve_texts(5, 5):
            r.shadow_note(t)
    report = reg.promotion_report("v2")
    assert report["replayed"] == 5
    assert report["verdictRegressions"] == \
        jreg.promotion_report("v2")["verdictRegressions"] == 5
    # the incumbent (or an empty sample) promotes trivially, as in JAX
    assert reg.promotion_report("v1")["promote"] is True


def test_shadow_ring_is_bounded():
    reg, _ = stub_pair("promo-ring", shadowWindow=8)
    for i in range(30):
        reg.shadow_note(f"text {i}")
    ring = reg.shadow_texts()
    assert len(ring) == 8 and ring[-1] == "text 29" and ring[0] == "text 22"


def test_process_book_lists_registries_by_name():
    a = port_registry("book-a")
    port_registry("book-b")
    b2 = port_registry("book-b")           # latest wins per name
    book = registry.all_registries()
    assert book["book-a"] is a and book["book-b"] is b2
    registry.clear_registries()
    assert registry.all_registries() == {}
