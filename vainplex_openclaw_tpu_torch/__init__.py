"""PyTorch and CUDA port of ``vainplex_openclaw_tpu``'s numeric layer.

The JAX package beside it is the reference; this package imports nothing of
it and never imports ``jax``. Module paths mirror the JAX package's
(``models/encoder.py``, ``ops/flash_attention.py``, …). Entry points take
``device=None``, which means the card, and raise when there is none unless
the caller asks for ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
