"""Tensor ops of the port: plain PyTorch, and the wrappers of the
hand-written kernels (each with its plain version beside it)."""

from vtp_tpu_torch.ops.ring_attention import ring_attention

__all__ = ["ring_attention"]
