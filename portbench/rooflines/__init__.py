"""The yardstick's arithmetic: the H100's peaks, the least time of one
attention launch, and the operations of one encoder forward.

``attention_bound`` is a frozen copy of ``chip_smoke.attention_bound``:
later changes to the program's own tools do not move it. Every count here
is of the work the requests need: the real rows of a batch and the real
tokens of each row, never the pow2 bucket or the padded sequence length
the program runs. A change that stops padding then leaves these counts
where they are and shows as a shorter time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: HBM bytes/s and the bf16
# tensor-core peak. Both assume the full 700 W power limit; the run prints
# the card's own limit beside its numbers.
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
# One exponential per score on the special function units: 132 SMs x 16
# ex2 per clock x ~1.83 GHz (FlashAttention-3, Shah et al., 2024).
SFU_EXP_PER_S = 3.9e12


def attention_bound(B, H, Lq, Lk, Dh, elem_bytes, stats,
                    ops_per_s=PEAK_BF16_OPS_PER_S):
    """The least time the card could take for one attention launch.

    Bytes: q, k, v read once in their dtype (``elem_bytes``), the fp32 bias
    row [B, Lk], and the output written once: in q's dtype (K1) or, with
    ``stats`` (K2), the fp32 acc and the fp32 m and l. Operations: 4 per
    score and head dimension (q . k and p . v). ``bound_ms`` is the larger
    of bytes over HBM_BYTES_PER_S and operations over ``ops_per_s``;
    ``exp_floor_ms`` is the one exponential per score over SFU_EXP_PER_S,
    a floor the bound does not see."""
    out_bytes = (B * H * Lq * Dh * 4 + 2 * B * H * Lq * 4 if stats
                 else B * H * Lq * Dh * elem_bytes)
    n_bytes = ((B * H * Lq * Dh + 2 * B * H * Lk * Dh) * elem_bytes
               + B * Lk * 4 + out_bytes)
    n_ops = 4 * B * H * Lq * Lk * Dh
    n_exp = B * H * Lq * Lk
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return {"bytes": n_bytes, "operations": n_ops, "exponentials": n_exp,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "exp_floor_ms": n_exp / SFU_EXP_PER_S * 1e3}


def rows_attention_bound(real_tokens, widths: dict, stats: bool,
                         elem_bytes: int = 2) -> dict:
    """The least time of every attention launch that serves rows of
    ``real_tokens`` real tokens each, over all ``n_layers`` layers: each
    row's bytes and operations at its own length (B=1, Lq=Lk=n), summed,
    and bound by whichever sum takes longer. Summing before the max is
    never above the sum of per-launch bounds, so a share of it stays a
    share."""
    H = widths["n_heads"]
    Dh = widths["d_model"] // H
    n_bytes = n_ops = 0
    for n in real_tokens:
        b = attention_bound(1, H, int(n), int(n), Dh, elem_bytes, stats)
        n_bytes += b["bytes"]
        n_ops += b["operations"]
    n_bytes *= widths["n_layers"]
    n_ops *= widths["n_layers"]
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_BF16_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "operations": n_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def encoder_flops(n: int, widths: dict) -> int:
    """Operations of one encoder forward over a row of ``n`` real tokens:
    per layer the q, k, v, o projections (8 n D²), the MLP (4 n D F) and
    attention (4 n² D: q . k and p . v over all heads); then the pooled
    heads (severity 4, keep 2, mood 5 and the D-wide embedding
    projection). The embedding gather, the norms and the softmax are not
    counted: they are not multiply-adds."""
    D, F = widths["d_model"], widths["d_ff"]
    per_layer = 8 * n * D * D + 4 * n * D * F + 4 * n * n * D
    return widths["n_layers"] * per_layer + 2 * D * (4 + 2 + 5 + D)


def rows_flops(real_tokens, widths: dict) -> int:
    return sum(encoder_flops(int(n), widths) for n in real_tokens)
