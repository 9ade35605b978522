"""The port's tokenizer, checkpoint reader and loader against the JAX package.

Token ids must be byte-equal, and every leaf the port loads must be
bit-equal to the JAX ``load_pretrained()`` leaf carried across through
``params_from_numpy``: the shipped checkpoint is the model the port serves.
"""

from __future__ import annotations

import json
import os

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
from vainplex_openclaw_tpu_torch.models.tokenizer import encode_texts
from vainplex_openclaw_tpu_torch.ops import similarity as port_similarity

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
        cfg = EncoderConfig(n_experts=2)
        with pytest.raises(NotImplementedError):
            params_from_numpy({}, cfg, "cpu")


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 31, 32, 33, 1000])
def test_batch_shape_helpers_match_jax(n):
    assert port_similarity.pow2_bucket(n) == jax_similarity.pow2_bucket(n)
    X = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    b = port_similarity.pow2_bucket(n)
    assert np.array_equal(port_similarity.pad_rows(X, b),
                          jax_similarity.pad_rows(X, b))
