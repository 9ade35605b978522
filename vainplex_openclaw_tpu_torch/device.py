"""Device resolution for the port's entry points.

Every entry point (``load_pretrained``, ``ContinuousBatcher``,
``make_local_call_llm``, ``shared_batcher``, ``ModelRegistry``,
``classify_findings``) takes ``device=None`` and resolves it here. ``None`` means the card. There is no fallback: a process
without a CUDA device must ask for the CPU by name, or the entry point
raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; any CUDA device raises ``RuntimeError`` when no
    card is present. A CUDA device also pins full-float32 matrix products:
    TF32 keeps about three decimal digits, and the fp32 heads and the fp32
    parity checks need all of them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but no CUDA device is available "
                "(pass device='cpu' to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def backend_family(device: DeviceLike = None) -> str:
    """The device-family axis of the block and plan tables: ``"cuda"`` for
    a CUDA device, else the device's type; with no device, ``"cuda"`` when
    a card is visible and ``"cpu"`` otherwise. Tiles and plans searched on
    one family never drive another."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type
