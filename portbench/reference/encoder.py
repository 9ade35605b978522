"""The plain reference of the encoder the program serves: the
CortexEncoder's equations in plain PyTorch, in float32 with TF32 off.

It imports nothing of the program. It takes the weights as a flat
``{path: array}`` dict, the layout of the checkpoint's npz (``embed/tok``,
``blocks/0/attn/q``, ...; matrices ``[in, out]``), and tokens from
``reference/text.py``'s frozen tokenizer. The equations:

- x = tok[ids] + pos[0..n); per block x += attn(rmsnorm1(x)) then
  x += gelu_tanh(rmsnorm2(x) @ w1) @ w2;
- RMSNorm: x * rsqrt(mean(x²) + 1e-6) * scale;
- attention: softmax(q kᵀ / √Dh) v per head over the valid keys (id > 0);
- the heads on the final RMSNorm's mean over the valid tokens.

Departures from the program's own numerics, each deliberate:

- Everything is float32. The program runs its body in bfloat16 (the
  configuration's dtype) and keeps norms, softmax, pooling and heads in
  float32; the gap between the two is what the limits hold.
- A row is computed over its real tokens only: the program pads rows to
  the sequence length and masks the padded keys with a bias of -1e30, which
  makes their weight exactly 0 in float32, and padded queries never reach
  the pooled mean. The result is the same; the work is the row's own.
- Attention is computed in blocks of query rows, as many as keep a block
  of scores within ``score_budget`` values, so an L = 16384 row never
  holds its whole L × L scores at once.

``precision="fp8"`` is the control: every matrix product's two inputs
(weights, activations, q, k, the unnormalized probabilities and v) are
rounded to float8 e4m3 with a scale per row (per token of an activation,
per output column of a weight) before a float32 product, one step below the
configuration's bfloat16. Norms, softmax, pooling and heads stay float32, as
the program keeps them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def load_npz(path: str) -> dict:
    """``{path: float32 array}`` from a checkpoint's npz, whatever float
    type it stores."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], dtype=np.float32) for k in z.files}


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Reference:
    """The encoder over ``weights`` on ``device`` in ``precision``
    (``"fp32"`` or the ``"fp8"`` control)."""

    def __init__(self, weights: dict, widths: dict, device="cpu",
                 precision: str = "fp32", score_budget: int = 1 << 28):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.widths = widths
        self.fp8 = precision == "fp8"
        self.score_budget = int(score_budget)
        self.w = {k: torch.as_tensor(np.asarray(v, dtype=np.float32))
                  .to(self.device) for k, v in weights.items()}
        if self.fp8:
            for k, v in self.w.items():
                if "/attn/" in k or "/mlp/" in k:
                    self.w[k] = _fp8(v, 0)   # one scale per output column
                elif k == "embed/tok" or k == "embed/pos":
                    self.w[k] = _fp8(v, 1)   # one scale per table row

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _fp8(x, -1)
        return x @ w

    @staticmethod
    def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6) \
            * scale

    def _attention(self, h: torch.Tensor, i: int,
                   valid: torch.Tensor) -> torch.Tensor:
        B, L, D = h.shape
        H = self.widths["n_heads"]
        Dh = D // H
        q, k, v = (self._mm(h, self.w[f"blocks/{i}/attn/{n}"])
                   .reshape(B, L, H, Dh).transpose(1, 2)
                   for n in ("q", "k", "v"))
        if self.fp8:
            q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
        bias = torch.where(valid, 0.0, -1e30)[:, None, None, :]
        out = torch.empty_like(q)
        q_block = max(1, min(L, self.score_budget // (B * H * L)))
        for s in range(0, L, q_block):
            e = min(L, s + q_block)
            scores = q[:, :, s:e] @ k.transpose(-1, -2) / math.sqrt(Dh) + bias
            m = scores.amax(dim=-1, keepdim=True)
            p = torch.exp(scores - m)
            den = p.sum(dim=-1, keepdim=True)
            if self.fp8:
                p = _fp8(p, -1)
            out[:, :, s:e] = (p @ v) / den
        merged = out.transpose(1, 2).reshape(B, L, D)
        return self._mm(merged, self.w[f"blocks/{i}/attn/o"])

    def _mlp(self, h: torch.Tensor, i: int) -> torch.Tensor:
        up = F.gelu(self._mm(h, self.w[f"blocks/{i}/mlp/w1"]),
                    approximate="tanh")
        return self._mm(up, self.w[f"blocks/{i}/mlp/w2"])

    def _pooled(self, ids: torch.Tensor) -> torch.Tensor:
        """ids ``[B, n]`` (already cut to the block's longest row) → the
        float32 mean of the final norm over the valid tokens, ``[B, D]``."""
        valid = ids > 0
        n = ids.shape[1]
        x = self.w["embed/tok"][ids.long()] + self.w["embed/pos"][:n][None]
        for i in range(self.widths["n_layers"]):
            x = x + self._attention(
                self._rmsnorm(x, self.w[f"blocks/{i}/norm1/scale"]), i, valid)
            x = x + self._mlp(
                self._rmsnorm(x, self.w[f"blocks/{i}/norm2/scale"]), i)
        x = self._rmsnorm(x, self.w["final_norm/scale"])
        mask = valid.float()[:, :, None]
        return (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)

    def logits(self, tokens: np.ndarray, head: str,
               token_budget: int = 1 << 20) -> torch.Tensor:
        """``head``'s float32 logits ``[len(tokens), C]`` on the CPU for the
        ``[B, L]`` token rows (``head`` is ``severity``, ``keep`` or
        ``mood``)."""
        return self.pooled(tokens, token_budget) \
            @ self.w[f"heads/{head}"].cpu()

    @torch.inference_mode()
    def pooled(self, tokens: np.ndarray,
               token_budget: int = 1 << 20) -> torch.Tensor:
        """The pooled float32 vectors ``[len(tokens), D]`` on the CPU,
        computed in blocks of rows of like length (each block cut to its
        longest row) of at most ``token_budget`` tokens."""
        tokens = np.asarray(tokens)
        lengths = (tokens > 0).sum(axis=1)
        order = np.argsort(lengths, kind="stable")
        out = torch.empty((len(tokens), self.widths["d_model"]),
                          dtype=torch.float32)
        start = 0
        while start < len(order):
            n = max(1, int(lengths[order[start]]))
            stop = start + 1
            # grow the block while its rows, cut to the longest, fit
            while stop < len(order) and \
                    (stop + 1 - start) * max(n, int(lengths[order[stop]])) \
                    <= token_budget:
                n = max(n, int(lengths[order[stop]]))
                stop += 1
            idx = order[start:stop]
            ids = torch.from_numpy(tokens[idx, :n].copy()).to(self.device)
            out[torch.from_numpy(idx)] = self._pooled(ids).cpu()
            start = stop
        return out
