"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin;
and the training attention (a library call on the card, no TPU kernel
behind it)."""
