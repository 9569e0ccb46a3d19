"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin;
and the training attention (a library call on the card, no TPU kernel
behind it).  Importing this package builds and loads nothing: a kernel's
library loads at its first launch."""

from .decode_attention import decode_attention, decode_attention_reference

__all__ = ["decode_attention", "decode_attention_reference"]
