"""The triage encoder, its checkpoint loader and its serve path."""

from .encoder import EncoderConfig, forward, params_from_numpy
from .tokenizer import encode_texts

__all__ = ["EncoderConfig", "encode_texts", "forward", "params_from_numpy"]
