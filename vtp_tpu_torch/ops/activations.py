"""Activation functions (port of ``vtp_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU."""
    return F.gelu(x, approximate="none")


ACT = {
    "gelu": gelu_exact,
    "quick_gelu": quick_gelu,
    "silu": F.silu,
}
