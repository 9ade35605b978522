"""The port's tile search and block table against the JAX package's.

``vainplex_openclaw_tpu_torch/ops/kernel_search.py`` sweeps (block_q,
block_k) builds of K1/K2 per (family, dtype, pow2 bucket); winners land in
``ops/flash_block_table.json``, which every CUDA launch reads. These tests
run JAX's ``tests/test_kernel_search.py`` cases on the port with the same
fakes (the winner beats the incumbent, a building candidate never wins,
an error is data, a tie keeps the incumbent, resume, error re-measure,
budget partial) and hold the port to the JAX package where both define
the same thing: ``search_common`` state files cross between the packages,
``validate_table`` gives JAX's findings, ``table_key``/``table_entry``
read a table alike. The port's gate adds a margin to JAX's (5% and each
record's spread), and its parity check holds bf16 per row, with a control
that must fail the plain version without its first key tile. Tolerances:
tables, keys, findings and state records bit-equal; the point's chain of
K1 calls against the same chain through the Pallas interpreter within
1e-5 (fp32).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vainplex_openclaw_tpu.ops import flash_attention as jax_fa
from vainplex_openclaw_tpu.ops import kernel_search as jax_ks
from vainplex_openclaw_tpu.ops import search_common as jax_sc
from vainplex_openclaw_tpu_torch.ops import _build
from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
from vainplex_openclaw_tpu_torch.ops import kernel_search as ks
from vainplex_openclaw_tpu_torch.ops import search_common as sc


def fake_point(ms_by_pair, retraces_by_pair=None, calls=None):
    """A deterministic measure_point stand-in: (bq, bk) → fixed ms."""
    def _measure(L, bq, bk, *, dtype="bfloat16", steps=4, rounds=3,
                 seed=0, clock=None, device=None):
        if calls is not None:
            calls.append((L, bq, bk))
        rec = {"seq_len": L, "block_q": bq, "block_k": bk, "dtype": dtype,
               "steps": steps, "rounds": rounds, "seed": seed}
        ms = ms_by_pair.get((bq, bk))
        if ms is None:
            rec["error"] = "nvcc rejected the tile"
            return rec
        rec.update({"ms": ms, "spread": 0.01,
                    "retraces": (retraces_by_pair or {}).get((bq, bk), 0)})
        return rec
    return _measure


@pytest.fixture
def no_table(monkeypatch, tmp_path):
    """No block table anywhere (neither package), caches cleared."""
    monkeypatch.setenv(fa.TABLE_ENV, str(tmp_path / "none.json"))
    fa.clear_table_cache()
    jax_fa.clear_table_cache()
    yield
    fa.clear_table_cache()
    jax_fa.clear_table_cache()


def search(*a, **kw):
    return ks.search(*a, device="cpu", **kw)


class TestCandidateEnumeration:
    def test_incumbent_first_then_clamped_pairs(self, no_table):
        pairs = ks.candidate_pairs(64, blocks=(8, 16, 128), family="cpu")
        assert pairs[0] == (fa.default_block(64, side="q", family="cpu"),
                            fa.default_block(64, side="k", family="cpu"))
        assert pairs[0] == fa.DEFAULT_TILES
        assert len(pairs) == len(set(pairs))
        for bq, bk in pairs:
            assert bq <= 64 and bk <= 64 and bq % 8 == 0 and bk % 8 == 0
        # JAX's heuristic also gives 64 at L = 64: the same sweep
        assert pairs == jax_ks.candidate_pairs(64, blocks=(8, 16, 128))

    def test_ragged_length_clamps_to_padded_roundup(self, no_table):
        pairs = ks.candidate_pairs(100, blocks=(128, 256), family="cpu")
        assert max(b for pair in pairs for b in pair) == 104

    def test_port_sides_and_the_long_bucket(self, no_table):
        pairs = ks.candidate_pairs(16384, family="cuda")
        assert pairs[0] == (64, 64) and len(pairs) == 4
        assert {b for p in pairs for b in p} == set(ks.DEFAULT_CANDIDATES)
        assert all(_build.tile_defines(p) is not None for p in pairs)

    @pytest.mark.parametrize("L", [1, 8, 100, 1500, 16384])
    @pytest.mark.parametrize("family", ["tpu", "cpu", "cuda"])
    def test_bucket_key_is_jax_key(self, L, family):
        assert ks.bucket_key(L, "bfloat16", family=family) == \
            jax_ks.bucket_key(L, "bfloat16", family=family)
        assert ks.bucket_key(1500, "bfloat16", family="tpu") == \
            "tpu:bfloat16:2048"


class TestSearchLoop:
    def test_winner_must_beat_incumbent(self, monkeypatch, no_table):
        monkeypatch.setattr(ks, "measure_point", fake_point(
            {(64, 64): 10.0, (16, 16): 4.0, (16, 32): 6.0, (32, 16): 6.5,
             (32, 32): 5.0}))
        res = search((64,), blocks=(16, 32))
        (key, r), = res.items()
        assert key == "cpu:bfloat16:64"
        assert r["baseline"]["ms"] == 10.0
        assert (r["best"]["block_q"], r["best"]["block_k"]) == (16, 16)
        assert r["improved"] is True

    def test_building_candidate_never_wins(self, monkeypatch, no_table):
        """The gate: faster AND no build while timed."""
        monkeypatch.setattr(ks, "measure_point", fake_point(
            {(64, 64): 10.0, (16, 16): 3.0, (32, 32): 5.0},
            retraces_by_pair={(16, 16): 2}))
        (_, r), = search((64,), blocks=(16, 32)).items()
        assert (r["best"]["block_q"], r["best"]["block_k"]) == (32, 32)

    def test_error_candidate_is_data_not_fatal(self, monkeypatch, no_table):
        monkeypatch.setattr(ks, "measure_point", fake_point(
            {(64, 64): 10.0, (32, 32): 8.0}))
        (_, r), = search((64,), blocks=(16, 32)).items()
        assert [c for c in r["candidates"] if c.get("error")]
        assert (r["best"]["block_q"], r["best"]["block_k"]) == (32, 32)

    @pytest.mark.parametrize("ms,spread,improved", [
        (9.6, 0.01, False),   # 4% faster: inside the 5% margin
        (9.0, 0.01, True),    # 10% faster, spread 1%
        (9.0, 0.12, False),   # 10% faster, inside its own 12% spread
    ])
    def test_a_gain_inside_the_margin_or_the_spread_keeps_incumbent(
            self, monkeypatch, no_table, ms, spread, improved):
        """The port's gate adds a margin to JAX's: a candidate must beat
        the incumbent by more than ``MIN_GAIN`` and by more than either
        record's round-to-round spread."""
        fake = fake_point({(64, 64): 10.0, (32, 32): ms})

        def measure(*a, **kw):
            rec = fake(*a, **kw)
            if (rec["block_q"], rec["block_k"]) == (32, 32):
                rec["spread"] = spread
            return rec

        monkeypatch.setattr(ks, "measure_point", measure)
        (_, r), = search((64,), blocks=(16, 32)).items()
        assert r["improved"] is improved
        assert (r["best"]["block_q"], r["best"]["block_k"]) == \
            ((32, 32) if improved else (64, 64))

    def test_tie_keeps_incumbent(self, monkeypatch, no_table):
        monkeypatch.setattr(ks, "measure_point", fake_point(
            {(64, 64): 5.0, (16, 16): 5.0, (32, 32): 5.0}))
        (_, r), = search((64,), blocks=(16, 32)).items()
        assert r["improved"] is False
        assert (r["best"]["block_q"], r["best"]["block_k"]) == (64, 64)

    def test_resume_skips_measured_points(self, tmp_path, monkeypatch,
                                          no_table):
        state = tmp_path / "sweep.json"
        calls: list = []
        monkeypatch.setattr(ks, "measure_point", fake_point(
            {(64, 64): 10.0, (16, 16): 4.0, (16, 32): 6.0, (32, 16): 6.5,
             (32, 32): 5.0}, calls=calls))
        first = search((64,), blocks=(16, 32), state_path=str(state))
        n_first = len(calls)
        assert n_first > 0 and state.exists()
        second = search((64,), blocks=(16, 32), state_path=str(state))
        assert len(calls) == n_first
        (_, r2), = second.items()
        (_, r1), = first.items()
        assert all(c.get("resumed") for c in r2["candidates"])
        assert (r2["best"]["block_q"], r2["best"]["block_k"]) == \
            (r1["best"]["block_q"], r1["best"]["block_k"])

    def test_resume_remeasures_error_records(self, tmp_path, monkeypatch,
                                             no_table):
        state = tmp_path / "sweep.json"
        calls: list = []
        monkeypatch.setattr(ks, "measure_point", fake_point(
            {(64, 64): 10.0, (16, 16): 4.0, (32, 32): 5.0}, calls=calls))
        search((64,), blocks=(16, 32), state_path=str(state))
        n_first = len(calls)
        monkeypatch.setattr(ks, "measure_point", fake_point(
            {(64, 64): 10.0, (16, 16): 4.0, (16, 32): 3.0, (32, 16): 6.5,
             (32, 32): 5.0}, calls=calls))
        (_, r2), = search((64,), blocks=(16, 32),
                          state_path=str(state)).items()
        assert len(calls) == n_first + 2  # exactly the two error points
        assert not any(c.get("error") for c in r2["candidates"])
        assert (r2["best"]["block_q"], r2["best"]["block_k"]) == (16, 32)

    def test_resume_state_survives_mid_sweep_kill(self, tmp_path,
                                                  monkeypatch, no_table):
        state = tmp_path / "sweep.json"
        calls: list = []
        good = fake_point({(64, 64): 10.0, (16, 16): 4.0, (32, 32): 5.0},
                          calls=calls)

        def dies_after_two(L, bq, bk, **kw):
            if len(calls) >= 2:
                raise KeyboardInterrupt("lost machine")
            return good(L, bq, bk, **kw)

        monkeypatch.setattr(ks, "measure_point", dies_after_two)
        with pytest.raises(KeyboardInterrupt):
            search((64,), blocks=(16, 32), state_path=str(state))
        assert len(json.loads(state.read_text())) == 2
        monkeypatch.setattr(ks, "measure_point", good)
        calls.clear()
        (_, r), = search((64,), blocks=(16, 32),
                         state_path=str(state)).items()
        resumed = [c for c in r["candidates"] if c.get("resumed")]
        assert len(resumed) == 2 and len(calls) == len(r["candidates"]) - 2

    def test_budget_records_partial_and_next_length_runs(self, monkeypatch,
                                                         no_table):
        monkeypatch.setattr(ks, "measure_point", fake_point(
            {(64, 64): 10.0, (16, 16): 4.0, (32, 32): 5.0,
             (16, 32): 6.0, (32, 16): 6.0}))
        t = {"now": 0.0}

        def clock():
            t["now"] += 10.0
            return t["now"]

        res = search((64, 128), blocks=(16, 32), budget_s_per_len=15.0,
                     clock=clock)
        r64 = res[ks.bucket_key(64, family="cpu")]
        assert r64["partial"] is True and r64["skipped_candidates"] > 0
        assert r64["baseline"] is not None
        assert res[ks.bucket_key(128, family="cpu")]["candidates"]

    def test_the_same_sweep_as_jax_with_the_same_fakes(self, monkeypatch,
                                                       no_table):
        ms = {(64, 64): 10.0, (16, 16): 4.0, (16, 32): 6.0, (32, 32): 5.0}
        monkeypatch.setattr(ks, "measure_point", fake_point(ms))
        monkeypatch.setattr(jax_ks, "measure_point", fake_point(ms))
        got = search((64,), blocks=(16, 32))
        want = jax_ks.search((64,), blocks=(16, 32))
        assert got == want
        assert ks.to_table(got)["entries"] == jax_ks.to_table(want)["entries"]


class TestSweepStateCrossesPackages:
    @pytest.mark.parametrize("writer,reader", [(jax_sc, sc), (sc, jax_sc)])
    def test_a_state_file_resumes_in_the_other_package(self, tmp_path,
                                                       writer, reader):
        path = str(tmp_path / "state.json")
        w = writer.SweepState(path, done_field="ms")
        key = writer.config_key("cuda:bfloat16:64:32x64", ("s", 4),
                                ("r", 3), ("seed", 0))
        assert key == reader.config_key("cuda:bfloat16:64:32x64", ("s", 4),
                                        ("r", 3), ("seed", 0))
        w.record(key, {"ms": 1.5, "retraces": 0, "resumed": True})
        w.record("err", {"error": "boom"})
        r = reader.SweepState(path, done_field="ms")
        assert r.finished(key) == {"ms": 1.5, "retraces": 0,
                                   "resumed": True}
        assert r.finished("err") is None
        assert reader.load_state(path) == writer.load_state(path)

    def test_unreadable_state_restarts(self, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        assert sc.load_state(str(bad)) == jax_sc.load_state(str(bad)) == {}
        sc.save_state(None, {"x": 1})  # a None path keeps nothing


def results(family="cuda"):
    return {f"{family}:bfloat16:64": {
        "seq_len": 64, "dtype": "bfloat16", "family": family,
        "baseline": {"block_q": 64, "block_k": 64, "ms": 10.0,
                     "retraces": 0, "seed": 0, "steps": 4, "rounds": 3},
        "best": {"block_q": 32, "block_k": 64, "ms": 4.0, "retraces": 0,
                 "seed": 0, "steps": 4, "rounds": 3},
        "candidates": [], "improved": True,
        "skipped_candidates": 0, "partial": False}}


class TestTableEmissionAndGate:
    def test_merge_preserves_other_families(self):
        base = {"schema": "flash-block-table-v1",
                "entries": {"tpu:bfloat16:8192":
                            {"block_q": 1024, "block_k": 1024, "ms": 14.8}}}
        table = ks.to_table(results(), base_table=base,
                            provenance={"card": "H100"})
        assert "tpu:bfloat16:8192" in table["entries"]
        assert table["entries"]["cuda:bfloat16:64"]["block_q"] == 32
        assert table["provenance"]["card"] == "H100"
        assert ks.validate_table(table) == []
        assert table["entries"] == jax_ks.to_table(
            results(), base_table=base)["entries"]

    def test_write_load_roundtrip_drives_default_block(self, tmp_path,
                                                       monkeypatch):
        table = ks.to_table(results())
        path = tmp_path / "table.json"
        ks.write_table(table, str(path))
        assert not (tmp_path / "table.json.tmp").exists()
        monkeypatch.setenv(fa.TABLE_ENV, str(path))
        fa.clear_table_cache()
        try:
            assert fa.default_block(64, "bfloat16", "q", "cuda") == 32
            assert fa.default_block(33, "bfloat16", "k", "cuda") == 64
            assert fa.launch_tiles(64, 64, "bfloat16") == (32, 64)
            # a miss: the compiled default, not JAX's TPU heuristic
            assert fa.default_block(16384, "bfloat16", "q", "cuda") == 64
            assert fa.launch_tiles(16384, 64, "bfloat16") == (64, 64)
            assert fa.default_block(64, "bfloat16", "q", "cpu") == 64
            assert fa.load_block_table(str(path))["entries"] == \
                table["entries"]
        finally:
            fa.clear_table_cache()

    @pytest.mark.parametrize("mutate", [
        lambda t: t.update(schema="v0"),
        lambda t: t["entries"].clear(),
        lambda t: t["entries"].update({"bad-key": {"block_q": 8,
                                                   "block_k": 8}}),
        lambda t: t["entries"].update({"cuda:bf16:100": {"block_q": 8,
                                                         "block_k": 8}}),
        lambda t: t["entries"].update({"cuda:bf16:x": {}}),
        lambda t: t["entries"]["cuda:bfloat16:64"].update(block_q=13),
        lambda t: t["entries"]["cuda:bfloat16:64"].update(block_q=512),
        lambda t: t["entries"]["cuda:bfloat16:64"].update(ms=-1.0),
        lambda t: t["entries"].update({"cuda:bfloat16:4": []}),
    ])
    def test_validate_table_findings_equal_jax(self, mutate):
        table = ks.to_table(results())
        mutate(table)
        findings = ks.validate_table(table)
        assert findings and findings == jax_ks.validate_table(table)

    def test_jax_shipped_table_gets_jax_findings(self):
        table = jax_fa.load_block_table(jax_fa.TABLE_PATH)
        assert table["entries"]
        assert ks.validate_table(table) == jax_ks.validate_table(table) == []

    def test_committed_table_passes_the_gate(self):
        with open(fa.TABLE_PATH, encoding="utf-8") as f:
            table = json.load(f)
        assert ks.validate_table(table) == jax_ks.validate_table(table) == []
        # only rows of the card, in bf16, from its own run
        assert table["entries"] and all(
            k.startswith("cuda:bfloat16:") for k in table["entries"])
        prov = table["provenance"]
        assert "H100" in prov["card"] and "W" in prov["card"]
        for ent in table["entries"].values():
            assert _build.tile_defines((ent["block_q"], ent["block_k"])) \
                is not None

    @pytest.mark.parametrize("L", [8, 64, 100, 512, 1000, 4096, 16384])
    @pytest.mark.parametrize("family", ["tpu", "cpu", "cuda"])
    def test_table_key_and_entry_equal_jax(self, L, family):
        assert fa.table_key(L, "bfloat16", family) == \
            jax_fa.table_key(L, "bfloat16", family)
        for path in (jax_fa.TABLE_PATH, fa.TABLE_PATH):
            assert fa.table_entry(L, "bfloat16", family, path) == \
                jax_fa.table_entry(L, "bfloat16", family, path)

    def test_malformed_row_is_no_entry_as_in_jax(self, tmp_path):
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"schema": "flash-block-table-v1",
                                    "entries": {"cuda:bfloat16:64": {
                                        "block_q": 12, "block_k": 64}}}))
        fa.clear_table_cache()
        assert fa.table_entry(64, "bfloat16", "cuda", str(path)) is None
        assert jax_fa.table_entry(64, "bfloat16", "cuda", str(path)) is None
        fa.clear_table_cache()


class TestTilesAndLibraries:
    def test_default_tiles_keep_todays_library_path(self):
        """No defines: the hash of the flags, the source and the headers,
        exactly as before tiles existed; the default tiles add none."""
        h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
        for path in [os.path.join(_build.CSRC_DIR, "flash_attention.cu")] + \
                sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        want = os.path.join(_build.BUILD_DIR,
                            f"libflash_attention-{h.hexdigest()[:16]}.so")
        assert _build.library_path("flash_attention") == want
        assert _build.tile_defines(None) == _build.tile_defines((64, 64)) \
            == ()
        assert _build.library_path(
            "flash_attention", _build.tile_defines(fa.DEFAULT_TILES)) == want

    def test_each_define_set_is_its_own_library(self):
        tiles = [(bq, bk) for bq in ks.DEFAULT_CANDIDATES
                 for bk in ks.DEFAULT_CANDIDATES]
        paths = {_build.library_path("flash_attention",
                                     _build.tile_defines(t)) for t in tiles}
        assert len(paths) == len(tiles)
        assert _build.tile_defines((128, 32)) == ("-DFLASH_WARPS=8",
                                                  "-DFLASH_BN=32")
        assert _build.label("flash_attention", ("-DFLASH_BN=32",)) == \
            "flash_attention[-DFLASH_BN=32]"

    def test_every_candidate_is_a_tile_the_body_compiles(self):
        """The search's candidate pairs at every length it is run at are
        tiles the bf16 body compiles (block_q one or two warpgroups,
        block_k a multiple of 16 up to 128), and both committed table
        rows' tiles are among the candidates of their length."""
        for L in (64, 2048, 16384):
            for bq, bk in ks.candidate_pairs(L, family="cuda"):
                assert bq in _build.BLOCK_Q_SIDES
                assert bk in _build.BLOCK_K_SIDES
                _build.tile_defines((bq, bk))
        with open(fa.TABLE_PATH, encoding="utf-8") as f:
            rows = json.load(f)["entries"]
        assert {"cuda:bfloat16:64", "cuda:bfloat16:16384"} <= set(rows)
        for key, ent in rows.items():
            L = int(key.rsplit(":", 1)[1])
            assert (ent["block_q"], ent["block_k"]) in \
                ks.candidate_pairs(L, family="cuda")

    @pytest.mark.parametrize("dh", [16, 32, 64, 128])
    def test_shared_memory_of_every_tile_fits_a_block(self, dh):
        """The body's shared memory (``_build.flash_smem_bytes``, the
        mirror of ``Tiles<DH>``) stays within the 227 KB a block may opt
        in to at every tile it compiles; at the default 64 x 64 two blocks
        share an SM at every head dim."""
        for bq in _build.BLOCK_Q_SIDES:
            for bk in _build.BLOCK_K_SIDES:
                assert _build.flash_smem_bytes((bq, bk), dh) <= \
                    _build.SMEM_LIMIT
        assert 2 * (_build.flash_smem_bytes(_build.DEFAULT_TILES, dh)
                    + 1024) <= 228 * 1024

    def test_shared_memory_mirror_follows_the_header(self):
        """The mirror's constants are the header's: the stage budget and
        its bounds, the alignment slack and the barriers."""
        with open(os.path.join(_build.CSRC_DIR, "flash_attention_mma.cuh"),
                  encoding="utf-8") as f:
            src = f.read()
        assert "kFit = (100 * 1024 - kQBytes) / kStageBytes" in src
        assert "kStages = kFit > 4 ? 4 : (kFit < 2 ? 2 : kFit)" in src
        assert ("1024 + kQBytes + kStages * (kStageBytes + kBN * 4) + "
                "8 * (2 * kStages + 1)") in src
        # Dh 16 at 64 x 64: 2 KB of Q and four 4 KB stages of K and V
        assert _build.flash_smem_bytes((64, 64), 16) == \
            1024 + 2048 + 4 * (4096 + 256) + 8 * 9

    @pytest.mark.parametrize("tiles", [(24, 64), (64, 40), (8, 8), (0, 64)])
    def test_a_tile_the_kernel_cannot_take_raises(self, tiles):
        """A table row that JAX's test accepts (multiples of 8) but the
        kernel cannot take raises at the launch: no fallback."""
        with pytest.raises(ValueError, match="multiples of 16"):
            _build.tile_defines(tiles)

    def test_cpu_flash_attention_is_unchanged_by_any_table(self, tmp_path,
                                                          monkeypatch):
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"schema": "flash-block-table-v1",
                                    "entries": {
                                        "cpu:float32:64": {"block_q": 24,
                                                           "block_k": 8},
                                        "cuda:float32:64": {"block_q": 128,
                                                            "block_k": 32}}}))
        monkeypatch.setenv(fa.TABLE_ENV, str(path))
        fa.clear_table_cache()

        def refuse(*_a, **_kw):
            raise AssertionError("a CPU tensor reached the build")

        monkeypatch.setattr(_build, "load_library", refuse)
        monkeypatch.setattr(fa, "load_block_table", refuse)
        gen = torch.Generator().manual_seed(3)
        q, k, v = (torch.randn((2, 2, 64, 16), generator=gen)
                   for _ in range(3))
        mask = torch.ones((2, 64), dtype=torch.bool)
        want = fa.flash_attention_reference(q, k, v, mask)
        assert torch.equal(fa.flash_attention(q, k, v, mask), want)
        assert torch.equal(fa.flash_attention(q, k, v, mask, block_q=32,
                                              block_k=128), want)


class TestMeasuredPoint:
    def test_one_real_point_on_the_cpu(self):
        rec = ks.measure_point(16, 16, 16, steps=1, rounds=1, seed=0,
                               device="cpu")
        assert "error" not in rec, rec.get("error")
        assert rec["ms"] > 0 and rec["retraces"] == 0
        assert rec["launches"] == 0  # the plain version: no kernel
        assert rec["max_abs_err"] == rec["k1_err"] == rec["k2_err"] == 0.0
        assert "k1_control" not in rec  # 16 keys: below CONTROL_MIN_L
        assert (rec["seq_len"], rec["block_q"], rec["block_k"]) == \
            (16, 16, 16)

    def test_a_failing_candidate_is_an_error_record(self, monkeypatch):
        monkeypatch.setattr(ks, "parity_errors", lambda *a, **kw: {
            "k1": 0.5, "k2": 0.0, "max_abs_err": 0.5})
        rec = ks.measure_point(16, 32, 32, steps=1, rounds=1, device="cpu")
        assert "parity" in rec["error"] and "ms" not in rec

    def test_a_control_the_check_passes_is_an_error_record(self,
                                                           monkeypatch):
        """From CONTROL_MIN_L keys the check must fail the plain version
        without its first key tile, or the point is not measured."""
        monkeypatch.setattr(ks, "CONTROL_MIN_L", 16)
        monkeypatch.setattr(ks, "parity_errors", lambda *a, **kw: {
            "k1": 0.0, "k2": 0.0, "max_abs_err": 0.0,
            "k1_control": 0.5, "k2_control": 0.01})
        rec = ks.measure_point(16, 32, 32, steps=1, rounds=1, device="cpu")
        assert "first 64 keys" in rec["error"] and "ms" not in rec

    @pytest.mark.parametrize("Dh", [16, 64])
    def test_the_check_fails_a_dropped_key_tile_at_16384_keys(self, Dh):
        """bf16, per row: the plain version without its first key tile
        misses K1 and K2 by far more than 3e-2, while its absolute K1
        error stays inside 3e-2 (rows that average 16384 keys have
        |out| ~ 0.01), so only the per-row measure sees it."""
        from vainplex_openclaw_tpu_torch.ops.flash_attention import \
            flash_attention_reference

        tol = ks.PARITY_TOL["bfloat16"]
        gen = torch.Generator().manual_seed(3)
        q, k, v = (torch.randn((1, 2, 128 if i == 0 else 16384, Dh),
                               generator=gen).to(torch.bfloat16)
                   for i in range(3))
        got = ks.parity_errors(q, k, v, (64, 64), control=True)
        assert got["k1"] <= tol and got["k2"] <= tol
        assert got["k1_control"] > 3 * tol and got["k2_control"] > 3 * tol
        ref = flash_attention_reference(q, k, v)
        dropped = flash_attention_reference(
            q, k[:, :, 64:].contiguous(), v[:, :, 64:].contiguous())
        assert ks.held_error(dropped, ref, per_row=False) <= tol
        assert ks.held_error(dropped, ref, per_row=True) == \
            pytest.approx(got["k1_control"])

    def test_held_error_scales_each_row_by_its_largest_value(self):
        ref = torch.tensor([[1.0, -2.0], [0.01, 0.02]])
        out = ref + torch.tensor([[0.02, 0.0], [0.0, 0.001]])
        assert ks.held_error(out, ref, per_row=False) == pytest.approx(0.02)
        assert ks.held_error(out, ref, per_row=True) == pytest.approx(0.05)

    def test_point_inputs_are_seeded_per_length(self):
        a = ks.point_inputs(32, "float32", 0, "cpu")
        b = ks.point_inputs(32, "float32", 0, "cpu")
        c = ks.point_inputs(64, "float32", 0, "cpu")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert a[0].shape == (4, 8, 32, 64) and c[0].shape[2] == 64
        assert not torch.equal(a[0], c[0][:, :, :32])

    def test_the_chain_equals_jax_steps_through_pallas(self):
        """The timed chain: each K1 output, rescaled by 1/1.125, is the
        next query, as JAX's ``_point_runner`` step (Pallas interpreter,
        fp32)."""
        q0, k, v = ks.point_inputs(32, "float32", 1, "cpu", (1, 2, 16))
        got = ks._chain(q0, k, v, (16, 16), 3)
        jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q0, k, v))
        mask = jnp.ones((1, 32), bool)
        for _ in range(3):
            o = jax_fa.flash_attention(jq, jk, jv, mask, block_q=16,
                                       block_k=16, interpret=True)
            jq = (o / jnp.float32(1.125)).astype(jq.dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(jq), atol=1e-5)


def test_search_defaults_to_the_card():
    """No card here: ``search`` without ``device`` raises before it
    measures anything, as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ks.search((64,), steps=1, rounds=1)
