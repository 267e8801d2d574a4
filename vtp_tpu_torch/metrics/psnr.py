"""PSNR (port of ``vtp_tpu/metrics/psnr.py``), the reference's formula
(tools/test_reconstruction_hf.py:49-62): inputs in [0, 255],
``20 log10(255 / sqrt(mse))`` per image."""

from __future__ import annotations

import torch


def psnr(original: torch.Tensor, processed: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """Per-image PSNR over (B, ...) tensors in fp32; returns (B,), infinite
    for exact matches, like the reference."""
    b = original.shape[0]
    diff = (original.float() - processed.float()).reshape(b, -1)
    mse = (diff * diff).mean(-1)
    value = 20.0 * torch.log10(max_val / torch.sqrt(mse.clamp_min(1e-20)))
    return torch.where(mse == 0, torch.full_like(value, float("inf")), value)
