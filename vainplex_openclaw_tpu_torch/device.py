"""Device resolution for the port's entry points.

Every entry point (``load_pretrained``, ``ContinuousBatcher``,
``make_local_call_llm``, ``shared_batcher``, ``ModelRegistry``,
``classify_findings``) takes ``device=None`` and resolves it here. ``None`` means the card. There is no fallback: a process
without a CUDA device must ask for the CPU by name, or the entry point
raises.

:class:`DeviceError` is what the port raises when the card is missing or a
kernel does not build or launch; :func:`is_device_error` also knows torch's
own CUDA errors. The trace analyzer's fault-tolerant stages catch a
stage's own faults and let these through.
"""

from __future__ import annotations

import re
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

# torch >= 2.8 raises AcceleratorError for a CUDA runtime error; earlier
# versions raise a RuntimeError that names CUDA, cuBLAS or cuDNN
_ACCELERATOR_ERRORS = tuple(
    t for t in (getattr(torch, "AcceleratorError", None),
                torch.OutOfMemoryError) if t is not None)
_DEVICE_MESSAGE = re.compile(r"CUDA|CUBLAS|cuDNN")


class DeviceError(RuntimeError):
    """No card where one was asked for, or a kernel of the port that did
    not build or launch."""


def is_device_error(exc: BaseException) -> bool:
    """True for an error that comes from the device: a
    :class:`DeviceError`, ``torch.OutOfMemoryError``, or a torch CUDA
    error."""
    if isinstance(exc, (DeviceError,) + _ACCELERATOR_ERRORS):
        return True
    return isinstance(exc, RuntimeError) and bool(
        _DEVICE_MESSAGE.search(str(exc)))


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; any CUDA device raises :class:`DeviceError` when no
    card is present. A CUDA device also pins full-float32 matrix products:
    TF32 keeps about three decimal digits, and the fp32 heads and the fp32
    parity checks need all of them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(
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
