"""Feed-forward networks (port of ``vtp_tpu/ops/ffn.py``).

Weights are in torch layout, ``(out, in)``. Inputs and weights are cast
to ``compute_dtype`` at each GEMM boundary, as torch autocast does; the
GEMMs themselves are plain ``torch.matmul`` (cuBLAS on the card). Without
a ``compute_dtype``, fp32 GEMMs run at ``precision``: "float32" (exact) or
"high" (the bf16x3 split of ``ops/precision.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from vtp_tpu_torch.ops.precision import check_precision, linear_high


def swiglu_hidden_dim(in_features: int, ffn_ratio: float, align_to: int = 8) -> int:
    """Hidden-size rule ``align(2/3 * ratio * dim)`` (ffn.py:71-72)."""
    hidden = int(in_features * ffn_ratio)
    d = int(hidden * 2 / 3)
    return d + (-d % align_to)


def ffn_align_to(ffn_layer: str) -> int:
    """swiglu / swiglu32 / swiglu64 / swiglu128 registry."""
    return {"swiglu": 8, "swiglu32": 32, "swiglu64": 64, "swiglu128": 128}[ffn_layer]


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           compute_dtype: Optional[torch.dtype] = None, precision: str = "float32"
           ) -> torch.Tensor:
    """``x @ weight.T + bias``; the bias is added in the product's dtype.
    ``precision="high"`` takes fp32 operands and no ``compute_dtype``."""
    check_precision(precision)
    if precision == "high":
        if compute_dtype is not None:
            raise ValueError("precision 'high' is for fp32 GEMMs; it takes no compute_dtype")
        y = linear_high(x, weight)
        return y if bias is None else y + bias.to(y.dtype)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    y = torch.matmul(x, weight.t())
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def swiglu(x: torch.Tensor, w1: torch.nn.Linear, w2: torch.nn.Linear, w3: torch.nn.Linear,
           compute_dtype: Optional[torch.dtype] = None, precision: str = "float32"
           ) -> torch.Tensor:
    """SwiGLU: ``w3(silu(w1 x) * w2 x)`` (ffn.py:77-81)."""
    x1 = linear(x, w1.weight, w1.bias, compute_dtype, precision)
    x2 = linear(x, w2.weight, w2.bias, compute_dtype, precision)
    return linear(F.silu(x1) * x2, w3.weight, w3.bias, compute_dtype, precision)


def mlp(x: torch.Tensor, fc1: torch.nn.Linear, fc2: torch.nn.Linear,
        act: Callable[[torch.Tensor], torch.Tensor],
        compute_dtype: Optional[torch.dtype] = None, precision: str = "float32"
        ) -> torch.Tensor:
    """Two-layer MLP (ffn.py:21-48)."""
    h = act(linear(x, fc1.weight, fc1.bias, compute_dtype, precision))
    return linear(h, fc2.weight, fc2.bias, compute_dtype, precision)
