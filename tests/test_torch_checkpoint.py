"""The port's tokenizer, checkpoint reader and loader against the JAX package.

Token ids must be byte-equal, and every leaf the port loads must be
bit-equal to the JAX ``load_pretrained()`` leaf carried across through
``params_from_numpy``: the shipped checkpoint is the model the port serves.
"""

from __future__ import annotations

import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vainplex_openclaw_tpu.models import checkpoint as jax_ckpt
from vainplex_openclaw_tpu.models import pretrained as jax_pretrained
from vainplex_openclaw_tpu.models.data import synthetic_split
from vainplex_openclaw_tpu.models.tokenizer import (
    encode_texts as jax_encode_texts)
from vainplex_openclaw_tpu.ops import similarity as jax_similarity
from vainplex_openclaw_tpu_torch.models import checkpoint as port_ckpt
from vainplex_openclaw_tpu_torch.models import pretrained as port_pretrained
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, flatten_tree, params_from_numpy)
from vainplex_openclaw_tpu_torch.models import tokenizer as port_tokenizer
from vainplex_openclaw_tpu_torch.models.tokenizer import encode_texts
from vainplex_openclaw_tpu_torch.ops import _build
from vainplex_openclaw_tpu_torch.ops import similarity as port_similarity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.reference.text import finding_text  # noqa: E402
from portbench.traffic import generator as traffic  # noqa: E402

MULTILINGUAL = [
    "Der Build ist fehlgeschlagen: Verbindung abgelehnt",
    "部署失败了，请检查 api-server 的日志",
    "デプロイが失敗しました。再試行してください",
    "배포가 실패했습니다",
    "deploy 🚀 failed 💥 after 3 retries 🔁",
    "İstanbul ıslak İI ıi — dotted and dotless i",
    "ΣΊΣΥΦΟΣ σίσυφος ς Σ — final sigma",
    "straße STRASSE ǅ ǆ ﬁ ligature",
    "$HOME/.ssh/id_rsa @ops #incident-42 /var/log/app.log",
    "",
    "   \t\n  ",
    "a" * 500 + " long " * 80,
]


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaf_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


class TestTokenizer:
    @pytest.mark.parametrize("seq_len,vocab", [(64, 2048), (128, 8192)])
    def test_synthetic_split_ids_byte_equal(self, seq_len, vocab):
        train, evals = synthetic_split(4096, 512, seed=0)
        texts = [t for t, _ in train + evals]
        got = encode_texts(texts, seq_len, vocab)
        want = jax_encode_texts(texts, seq_len, vocab)
        assert got.dtype == np.int32 and got.tobytes() == want.tobytes()

    @pytest.mark.parametrize("text", MULTILINGUAL)
    def test_multilingual_ids_byte_equal(self, text):
        got = encode_texts([text], 64, 2048)
        want = jax_encode_texts([text], 64, 2048)
        assert got.tobytes() == want.tobytes()

    def test_reserved_ids(self):
        ids = encode_texts(["hello world", ""], 8, 2048)
        assert (ids[:, 0] == 1).all()           # CLS
        assert (ids[1, 1:] == 0).all()          # PAD
        assert (ids[0, 1:3] >= 2).all()         # hashed words skip 0/1


def python_ids(texts, seq_len, vocab):
    """The port's Python loop over every row, as with no compiled pass."""
    out = np.zeros((len(texts), seq_len), np.int32)
    port_tokenizer._encode_python(texts, range(len(texts)), out, seq_len,
                                  vocab)
    return out


def counted(texts, seq_len, vocab):
    """``encode_texts`` and the rows it gave (compiled, Python)."""
    c0, p0 = port_tokenizer.compiled_rows, port_tokenizer.python_rows
    got = encode_texts(texts, seq_len, vocab)
    return got, (port_tokenizer.compiled_rows - c0,
                 port_tokenizer.python_rows - p0)


@pytest.fixture(scope="module")
def corpora():
    """The ``stage3_chat`` mix's 4,096 messages (3 to 3,840 words, most
    past 63) and 20,000 ``bulk_triage`` finding texts."""
    with open(os.path.join(REPO, "portbench", "traffic",
                           "stage3_chat.json")) as f:
        chat = traffic.generate(json.load(f), 0)
    found = traffic.findings(20000, traffic.rng_of(0, 2))
    return {"chat": chat, "bulk": [finding_text(f) for f in found]}


# Text the fuzz cases read: each names a case where lowering, \w, \s or
# UTF-8 could part the compiled pass from the regex.
UNICODE_CASES = {
    "final_sigma": "ΟΔΟΣ ΣΑΣ Σ. ΑΣ-ΣΑ",
    "dotted_i": "İstanbul İİ İ-i",
    "nbsp": "a\u00a0b\u00a0\u00a0c",
    "line_separator": "one\u2028two\u2029three",
    "info_separators": "a\x1cb\x1dc\x1ed\x1ff",
    "combining_marks": "cafe\u0301 n\u0303o \u0301alone \u20dd",
    "cjk": "部署失败了，请检查 api-server 的日志。デプロイ",
    "super_and_fractions": "x² ½ ³⁄₄ ⅷ ①",
    "arabic": "فشل النشر: مرفوض ٣ مرات",
    "zwj": "a\u200db \u200c \ufeff x\u200dy",
    "empty": "",
    "spaces": " \t\n\r\x0b\x0c\x85\u3000",
    "punctuation": "$HOME/.ssh @ops #42 a/b.c-d ... !!?? «»",
}
SEQ_VOCAB = [(1, 2048), (2, 2048), (64, 2048), (128, 8192)]


class TestCompiledTokenizer:
    """The compiled pass (``ops/csrc/tokenizer.cpp``) against the port's
    Python loop and JAX's ``encode_texts``, byte for byte."""

    @pytest.mark.parametrize("seq_len,vocab",
                             SEQ_VOCAB + [(64, 8192), (128, 2048)])
    @pytest.mark.parametrize("corpus", ["chat", "bulk"])
    def test_mix_byte_equal(self, corpora, corpus, seq_len, vocab):
        texts = corpora[corpus]
        got, (compiled, python) = counted(texts, seq_len, vocab)
        assert (compiled, python) == (len(texts), 0)
        assert got.dtype == np.int32
        assert got.tobytes() == python_ids(texts, seq_len, vocab).tobytes()
        assert got.tobytes() == jax_encode_texts(texts, seq_len,
                                                 vocab).tobytes()

    @pytest.mark.parametrize("seq_len,vocab", SEQ_VOCAB)
    @pytest.mark.parametrize("case", sorted(UNICODE_CASES))
    def test_unicode_byte_equal(self, case, seq_len, vocab):
        texts = [UNICODE_CASES[case], UNICODE_CASES[case].upper(),
                 (UNICODE_CASES[case] + " w") * 40]
        got, (compiled, python) = counted(texts, seq_len, vocab)
        assert (compiled, python) == (3, 0)
        assert got.tobytes() == python_ids(texts, seq_len, vocab).tobytes()
        assert got.tobytes() == jax_encode_texts(texts, seq_len,
                                                 vocab).tobytes()

    @pytest.mark.parametrize("text,taken", [
        ("deploy \U0001F680 failed", False),
        ("\U0001F4A5", False),
        ("w " * 70 + "\U0001F680", True),   # past the last kept word
        ("𝐀𝐁 bold", False),                  # astral letters are \w
    ])
    def test_astral_rows_fall_back_and_count(self, text, taken):
        texts = ["before", text, "after"]
        got, rows = counted(texts, 64, 2048)
        assert rows == ((3, 0) if taken else (2, 1))
        assert got.tobytes() == python_ids(texts, 64, 2048).tobytes()
        assert got.tobytes() == jax_encode_texts(texts, 64, 2048).tobytes()

    @pytest.mark.parametrize("text", ["a\ud800b", "ok \udfff", "\ud83d"])
    def test_lone_surrogate_raises_as_before(self, text):
        with pytest.raises(UnicodeEncodeError):
            jax_encode_texts(["fine", text], 64, 2048)
        with pytest.raises(UnicodeEncodeError):
            encode_texts(["fine", text], 64, 2048)

    def test_lone_surrogate_past_the_cut_encodes_as_before(self):
        texts = ["fine", "w " * 70 + "\ud800"]
        got, rows = counted(texts, 64, 2048)
        assert rows == (1, 1)
        assert got.tobytes() == jax_encode_texts(texts, 64, 2048).tobytes()

    @pytest.mark.parametrize("seed", range(4))
    def test_random_code_points_byte_equal(self, seed):
        """Rows of code points drawn over the BMP (no surrogates) and a
        few astral ones, short words and runs of spaces between them."""
        rng = np.random.default_rng(seed)
        pool = np.concatenate([np.arange(0x20, 0x80), np.arange(0x80, 0xD800),
                               np.arange(0xE000, 0x10000),
                               np.array([0x1F680, 0x1D400, 0x20000])])
        texts = []
        for _ in range(400):
            cps = rng.choice(pool, size=int(rng.integers(0, 120)))
            cuts = rng.random(len(cps)) < 0.2
            texts.append("".join(" " if cut else chr(cp)
                                 for cp, cut in zip(cps, cuts)))
        got = encode_texts(texts, 64, 8192)
        assert got.tobytes() == python_ids(texts, 64, 8192).tobytes()
        assert got.tobytes() == jax_encode_texts(texts, 64, 8192).tobytes()

    def test_class_table_agrees_with_the_regex(self):
        """Each BMP code point's class as ``_WORD_RE`` reads a pair of it:
        one token (WORD), none (SPACE) or two (OTHER)."""
        table = port_tokenizer.class_table()
        assert len(table) == 0x10000
        want = {1: port_tokenizer.WORD, 0: port_tokenizer.SPACE,
                2: port_tokenizer.OTHER}
        bad = [cp for cp in range(0x10000)
               if want[len(port_tokenizer._WORD_RE.findall(chr(cp) * 2))]
               != table[cp]]
        assert bad == []

    def test_eight_threads_give_the_serial_result(self, corpora):
        texts = corpora["chat"][:1024]
        batches = [texts[i::8] for i in range(8)]
        serial = [encode_texts(b, 64, 2048) for b in batches]
        got = [None] * 8
        start = threading.Barrier(8)

        def work(i):
            start.wait(timeout=30)
            for _ in range(5):
                out = encode_texts(batches[i], 64, 2048)
                assert out.tobytes() == serial[i].tobytes()
            got[i] = out

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert all(g is not None and g.tobytes() == s.tobytes()
                   for g, s in zip(got, serial))

    @pytest.mark.parametrize("failure", ["no_compiler", "compiler_fails"])
    def test_failed_build_falls_back(self, monkeypatch, tmp_path, corpora,
                                     failure):
        monkeypatch.setattr(port_tokenizer, "_native", None)
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
        if failure == "no_compiler":
            def none():
                raise _build.DeviceError("no host C++ compiler")
            monkeypatch.setattr(_build, "host_compiler", none)
        else:
            monkeypatch.setattr(_build, "HOST_FLAGS",
                                _build.HOST_FLAGS + ("-DTOKENIZER_BROKEN",
                                                     "-include", "absent.h"))
        texts = corpora["bulk"][:500] + ["deploy \U0001F680", ""]
        got, rows = counted(texts, 64, 2048)
        assert rows == (0, len(texts))
        assert got.tobytes() == jax_encode_texts(texts, 64, 2048).tobytes()
        assert port_tokenizer._native is False   # tried once, not per call
        assert os.listdir(tmp_path) == []         # no library, no temp file

    def test_library_builds_once_under_its_hash(self, monkeypatch, tmp_path):
        """Four threads build into an empty directory at once: one file
        named by the source's hash, no temporary left; a second call finds
        it and builds nothing."""
        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
        paths = []
        threads = [threading.Thread(
            target=lambda: paths.append(_build.build_host("tokenizer")))
            for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        want = _build.host_library_path("tokenizer", _build.host_compiler())
        assert paths == [want] * 4
        assert os.listdir(tmp_path) == [os.path.basename(want)]
        assert os.path.basename(want).startswith("libtokenizer-")
        mtime = os.stat(want).st_mtime_ns
        assert _build.build_host("tokenizer") == want
        assert os.stat(want).st_mtime_ns == mtime


class TestCheckpointReader:
    def test_steps_match_jax(self, tmp_path):
        d = jax_pretrained.DEFAULT_DIR
        assert port_ckpt.all_steps(d) == jax_ckpt.all_steps(d)
        assert port_ckpt.latest_step(d) == jax_ckpt.latest_step(d) == 600
        assert port_ckpt.all_steps(str(tmp_path / "none")) == []
        assert port_ckpt.latest_step(str(tmp_path)) is None

    def test_shipped_file_holds_23_float16_leaves(self):
        flat = port_ckpt.read_checkpoint(port_pretrained.DEFAULT_DIR)
        assert len(flat) == 23
        assert all(isinstance(a, np.ndarray) and a.dtype == np.float16
                   for a in flat.values())

    def test_bf16_uint_view_round_trips(self, tmp_path):
        rng = np.random.default_rng(0)
        w = rng.standard_normal((8, 4)).astype(ml_dtypes.bfloat16)
        tree = {"a": {"w": w},
                "b": rng.standard_normal((3,)).astype(np.float32),
                "c": np.arange(5, dtype=np.int32)}
        jax_ckpt.save_checkpoint(str(tmp_path), tree, step=7)
        flat = port_ckpt.read_checkpoint(str(tmp_path))
        assert flat["a/w"].dtype == torch.bfloat16
        assert np.array_equal(flat["a/w"].view(torch.int16).numpy(),
                              w.view(np.int16))
        assert flat["b"].dtype == np.float32 and \
            np.array_equal(flat["b"], tree["b"])
        assert np.array_equal(flat["c"], tree["c"])

    def test_missing_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            port_ckpt.read_checkpoint(str(tmp_path))


class TestLoadPretrained:
    def setup_method(self):
        port_pretrained.clear_cache()

    def test_default_dir_is_the_jax_package_file(self):
        assert os.path.samefile(port_pretrained.DEFAULT_DIR,
                                jax_pretrained.DEFAULT_DIR)
        assert port_pretrained.available()
        assert jax_pretrained.available() == port_pretrained.available()

    def test_config_matches_jax(self):
        cfg, _ = port_pretrained.load_pretrained(device="cpu")
        jcfg, _ = jax_pretrained.load_pretrained()
        for field in ("vocab_size", "seq_len", "d_model", "n_heads",
                      "n_layers", "d_ff", "n_severity", "n_mood",
                      "attn_impl", "n_experts", "scan_blocks"):
            assert getattr(cfg, field) == getattr(jcfg, field), field
        assert cfg.dtype == jnp.dtype(jcfg.dtype).name == "bfloat16"
        tiny = port_pretrained.TINY_CONFIG
        assert (tiny.vocab_size, tiny.seq_len, tiny.d_model, tiny.n_heads,
                tiny.n_layers, tiny.d_ff) == (2048, 64, 64, 4, 2, 256)

    def test_every_leaf_bit_equal_to_jax(self):
        cfg, params = port_pretrained.load_pretrained(device="cpu")
        _, jparams = jax_pretrained.load_pretrained()
        carried = flatten_tree(params_from_numpy(
            to_numpy_tree(jparams), cfg, "cpu", cast=False))
        mine = flatten_tree(params)
        assert set(mine) == set(carried) and len(mine) == 23
        for key, t in mine.items():
            assert t.dtype == carried[key].dtype, key
            assert np.array_equal(leaf_bits(t), leaf_bits(carried[key])), key
            jdt = np.asarray(flatten_jax(jparams)[key]).dtype.name
            assert str(t.dtype).replace("torch.", "") == jdt, key

    def test_cast_rule_keeps_norms_and_heads_fp32(self):
        _, params = port_pretrained.load_pretrained(device="cpu")
        for key, t in flatten_tree(params).items():
            keep = any(s in key.split("/") for s in
                       ("norm1", "norm2", "final_norm", "heads"))
            assert t.dtype == (torch.float32 if keep else torch.bfloat16), key

    def test_cached_per_dir_and_device(self):
        a = port_pretrained.load_pretrained(device="cpu")
        b = port_pretrained.load_pretrained(port_pretrained.DEFAULT_DIR,
                                            device=torch.device("cpu"))
        assert a is b
        port_pretrained.clear_cache()
        assert port_pretrained.load_pretrained(device="cpu") is not a

    def test_absent_checkpoint_is_none(self, tmp_path):
        assert port_pretrained.load_pretrained(str(tmp_path),
                                               device="cpu") is None
        assert not port_pretrained.available(str(tmp_path))

    def test_no_card_raises_without_cpu_request(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_pretrained.load_pretrained()

    def test_loads_a_jax_written_checkpoint_dir(self, tmp_path):
        """A checkpoint the JAX package writes (fp32 masters, its manifest,
        its config.json) loads through the port's reader."""
        from vainplex_openclaw_tpu.models import EncoderConfig as JCfg
        from vainplex_openclaw_tpu.models import init_params

        jcfg = JCfg(vocab_size=128, seq_len=16, d_model=32, n_heads=2,
                    n_layers=1, d_ff=64)
        tree = init_params(jax.random.PRNGKey(1), jcfg)
        jax_ckpt.save_checkpoint(str(tmp_path), to_numpy_tree(tree), step=3)
        (tmp_path / "config.json").write_text(json.dumps(
            {"config": jax_pretrained._config_to_manifest(jcfg)}))
        cfg, params = port_pretrained.load_pretrained(str(tmp_path),
                                                      device="cpu")
        _, jparams = jax_pretrained.load_pretrained(str(tmp_path))
        carried = flatten_tree(params_from_numpy(
            to_numpy_tree(jparams), cfg, "cpu", cast=False))
        for key, t in flatten_tree(params).items():
            assert np.array_equal(leaf_bits(t), leaf_bits(carried[key])), key
        jax_pretrained.clear_cache()


class TestCheckpointWriter:
    """``save_checkpoint`` and ``write_pretrained`` write what the JAX
    package reads, bit for bit, and the reverse still holds."""

    def setup_method(self):
        port_pretrained.clear_cache()
        jax_pretrained.clear_cache()

    def teardown_method(self):
        jax_pretrained.clear_cache()

    @staticmethod
    def long_cfg():
        from vainplex_openclaw_tpu_torch.models.long_context import (
            long_context_config)

        return long_context_config(128)

    def test_port_written_checkpoint_loads_in_jax(self, tmp_path):
        from vainplex_openclaw_tpu_torch.models.encoder import init_params

        cfg = self.long_cfg()
        tree = init_params(cfg, torch.Generator().manual_seed(3))
        port_pretrained.write_pretrained(str(tmp_path), cfg, tree)
        assert jax_pretrained.available(str(tmp_path))
        meta = json.loads((tmp_path / "config.json").read_text())
        assert meta == {"config": port_pretrained.config_to_manifest(cfg),
                        "eval": {}}
        jcfg, jparams = jax_pretrained.load_pretrained(str(tmp_path))
        assert jax_pretrained._config_to_manifest(jcfg) == meta["config"]
        # the fp32 masters as JAX restores them: every leaf bit-equal
        from vainplex_openclaw_tpu.models import init_params as jax_init

        raw = jax_ckpt.restore_checkpoint(
            str(tmp_path), like=jax_init(jax.random.PRNGKey(0), jcfg))
        jflat = flatten_jax(raw)
        mine = flatten_tree(tree)
        assert set(jflat) == set(mine)
        for key, t in mine.items():
            assert np.asarray(jflat[key]).dtype == np.float32, key
            assert np.array_equal(np.asarray(jflat[key]), t.numpy()), key
        # and the inference trees the two loaders build are bit-equal
        _, params = port_pretrained.load_pretrained(str(tmp_path),
                                                    device="cpu")
        carried = flatten_tree(params_from_numpy(
            to_numpy_tree(jparams), cfg, "cpu", cast=False))
        for key, t in flatten_tree(params).items():
            assert t.dtype == carried[key].dtype, key
            assert np.array_equal(leaf_bits(t), leaf_bits(carried[key])), key

    def test_bf16_leaves_stored_as_uint16_views(self, tmp_path):
        w = torch.randn((8, 4), generator=torch.Generator().manual_seed(0))
        tree = {"a": {"w": w.to(torch.bfloat16)}, "b": [w[0].clone()],
                "c": np.arange(5, dtype=np.int32)}
        path = port_ckpt.save_checkpoint(str(tmp_path), tree, step=5)
        assert path.endswith("step-5.npz")
        with np.load(path) as z:
            assert z["a/w"].dtype == np.uint16
        manifest = json.loads((tmp_path / "step-5.manifest.json").read_text())
        assert manifest["dtypes"] == {"a/w": "bfloat16", "b/0": "float32",
                                      "c": "int32"}
        assert manifest["leaves"] == ["a/w", "b/0", "c"]
        assert manifest["step"] == 5 and manifest["n_leaves"] == 3
        like = {"a": {"w": np.zeros((8, 4), ml_dtypes.bfloat16)},
                "b": [np.zeros(4, np.float32)], "c": np.zeros(5, np.int32)}
        restored = jax_ckpt.restore_checkpoint(str(tmp_path), like=like)
        jw = np.asarray(flatten_jax(restored)["a/w"])
        assert jw.dtype == ml_dtypes.bfloat16
        assert np.array_equal(jw.view(np.int16),
                              tree["a"]["w"].view(torch.int16).numpy())
        back = port_ckpt.read_checkpoint(str(tmp_path))
        assert torch.equal(back["a/w"], tree["a"]["w"])

    def test_keeps_the_newest_steps_and_leaves_no_temporaries(self, tmp_path):
        tree = {"w": torch.zeros(2)}
        for step in (1, 2, 3, 4, 5):
            port_ckpt.save_checkpoint(str(tmp_path), tree, step=step, keep=3)
        assert port_ckpt.all_steps(str(tmp_path)) == \
            jax_ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
        assert sorted(os.listdir(tmp_path)) == sorted(
            f"step-{s}.{ext}" for s in (3, 4, 5)
            for ext in ("npz", "manifest.json"))

    def test_failed_write_leaves_nothing_behind(self, tmp_path):
        with pytest.raises(TypeError):
            port_ckpt.save_checkpoint(str(tmp_path), {"w": torch.zeros(1)},
                                      step=1, metadata={"bad": object()})
        assert os.listdir(tmp_path) == []

    def test_jax_written_long_checkpoint_loads_in_port(self, tmp_path):
        import bench

        jcfg = bench.long_context_config(128)
        bench.write_serving_checkpoint(str(tmp_path), jcfg, seed=2)
        cfg, params = port_pretrained.load_pretrained(str(tmp_path),
                                                      device="cpu")
        assert port_pretrained.config_to_manifest(cfg) == \
            jax_pretrained._config_to_manifest(jcfg)
        _, jparams = jax_pretrained.load_pretrained(str(tmp_path))
        carried = flatten_tree(params_from_numpy(
            to_numpy_tree(jparams), cfg, "cpu", cast=False))
        for key, t in flatten_tree(params).items():
            assert np.array_equal(leaf_bits(t), leaf_bits(carried[key])), key


def flatten_jax(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


class TestParamsFromNumpy:
    def test_cast_true_applies_jax_cast_params(self):
        from vainplex_openclaw_tpu.models import EncoderConfig as JCfg
        from vainplex_openclaw_tpu.models import cast_params, init_params

        jcfg = JCfg(vocab_size=64, seq_len=8, d_model=16, n_heads=2,
                    n_layers=2, d_ff=32)
        cfg = EncoderConfig(vocab_size=64, seq_len=8, d_model=16, n_heads=2,
                            n_layers=2, d_ff=32)
        f32 = init_params(jax.random.PRNGKey(0), jcfg)
        got = flatten_tree(params_from_numpy(to_numpy_tree(f32), cfg, "cpu"))
        want = flatten_jax(cast_params(f32, jnp.bfloat16))
        for key, t in got.items():
            w = np.asarray(want[key])
            assert str(t.dtype).replace("torch.", "") == w.dtype.name, key
            bits = w.view(np.int16) if w.dtype.name == "bfloat16" else w
            assert np.array_equal(leaf_bits(t), bits), key

    def test_layout_is_jax_in_out(self):
        cfg = EncoderConfig(vocab_size=64, seq_len=8, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32)
        from vainplex_openclaw_tpu_torch.models.encoder import (
            param_shapes, unflatten_tree)

        flat = {k: np.full(s, 1.0, np.float32)
                for k, s in param_shapes(cfg).items()}
        flat["blocks/0/mlp/w1"] = np.arange(16 * 32, dtype=np.float32)\
            .reshape(16, 32)
        p = params_from_numpy(unflatten_tree(flat), cfg, "cpu", cast=False)
        w1 = p["blocks"][0]["mlp"]["w1"]
        assert tuple(w1.shape) == (16, 32)  # [in, out], x @ w
        assert float(w1[1, 0]) == 32.0

    @pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
    def test_tree_mismatch_raises(self, fault):
        cfg = EncoderConfig(vocab_size=64, seq_len=8, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32)
        from vainplex_openclaw_tpu_torch.models.encoder import (
            param_shapes, unflatten_tree)

        flat = {k: np.zeros(s, np.float32)
                for k, s in param_shapes(cfg).items()}
        if fault == "missing":
            del flat["heads/keep"]
        elif fault == "extra":
            flat["heads/other"] = np.zeros((16, 2), np.float32)
        else:
            flat["heads/keep"] = np.zeros((16, 3), np.float32)
        with pytest.raises((KeyError, ValueError)):
            params_from_numpy(unflatten_tree(flat), cfg, "cpu")

    def test_moe_config_not_ported(self):
        """An MoE config is ported now; a tree without its ``moe`` leaves
        is refused like any other missing leaf."""
        cfg = EncoderConfig(n_experts=2)
        with pytest.raises(KeyError, match="moe"):
            params_from_numpy({}, cfg, "cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 31, 32, 33, 1000])
def test_batch_shape_helpers_match_jax(n):
    assert port_similarity.pow2_bucket(n) == jax_similarity.pow2_bucket(n)
    X = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    b = port_similarity.pow2_bucket(n)
    assert np.array_equal(port_similarity.pad_rows(X, b),
                          jax_similarity.pad_rows(X, b))
