"""Tensor ops of the port: plain PyTorch, and the wrappers of the
hand-written kernels (each with its plain version beside it)."""
