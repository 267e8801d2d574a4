"""Feed-forward networks (port of ``vtp_tpu/ops/ffn.py``).

Weights are in torch layout, ``(out, in)``. Inputs and weights are cast
to ``compute_dtype`` at each GEMM boundary, as torch autocast does; the
GEMMs themselves are plain ``torch.matmul`` (cuBLAS on the card). Without
a ``compute_dtype``, fp32 GEMMs run at ``precision``: "float32" (exact) or
"high" (the bf16x3 split of ``ops/precision.py``). An int8 weight
(``utils.quantization.Int8Weight``) runs the W8A8 product instead
(``int8_linear``, :31-38), so a model whose weights were quantized runs
its own forwards quantized; ``swiglu`` takes a fused ``w12`` up-projection
(``utils.params.fuse_ffn_params``, :63-74).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from vtp_tpu_torch.ops.precision import check_precision, linear_high
from vtp_tpu_torch.utils.quantization import Int8Weight, int8_linear


def swiglu_hidden_dim(in_features: int, ffn_ratio: float, align_to: int = 8) -> int:
    """Hidden-size rule ``align(2/3 * ratio * dim)`` (ffn.py:71-72)."""
    hidden = int(in_features * ffn_ratio)
    d = int(hidden * 2 / 3)
    return d + (-d % align_to)


def ffn_align_to(ffn_layer: str) -> int:
    """swiglu / swiglu32 / swiglu64 / swiglu128 registry."""
    return {"swiglu": 8, "swiglu32": 32, "swiglu64": 64, "swiglu128": 128}[ffn_layer]


def linear(x: torch.Tensor, weight: Union[torch.Tensor, Int8Weight],
           bias: Optional[torch.Tensor] = None, compute_dtype: Optional[torch.dtype] = None,
           precision: str = "float32") -> torch.Tensor:
    """``x @ weight.T + bias``; the bias is added in the product's dtype.
    ``precision="high"`` takes fp32 operands and no ``compute_dtype``. An
    ``Int8Weight`` gives the fp32 W8A8 product with the bias added in fp32,
    cast to ``compute_dtype`` when one is given; it has no "high" mode.
    Without a ``compute_dtype``, operands of two float dtypes (a weight that
    ``cast_matmul_params`` stored in bf16) meet in the promoted one."""
    check_precision(precision)
    if isinstance(weight, Int8Weight):
        if precision == "high":
            raise ValueError("an int8 weight has no 'high' (bf16x3) mode")
        y = int8_linear(x, weight, bias)
        return y if compute_dtype is None else y.to(compute_dtype)
    if precision == "high":
        if compute_dtype is not None:
            raise ValueError("precision 'high' is for fp32 GEMMs; it takes no compute_dtype")
        y = linear_high(x, weight)
        return y if bias is None else y + bias.to(y.dtype)
    if compute_dtype is None and weight.dtype != x.dtype:
        compute_dtype = torch.promote_types(x.dtype, weight.dtype)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    y = torch.matmul(x, weight.t())
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def swiglu(x: torch.Tensor, w1: Optional[torch.nn.Linear], w2: Optional[torch.nn.Linear],
           w3: torch.nn.Linear, compute_dtype: Optional[torch.dtype] = None,
           precision: str = "float32", w12: Optional[torch.nn.Linear] = None) -> torch.Tensor:
    """SwiGLU: ``w3(silu(w1 x) * w2 x)`` (ffn.py:77-81). With a fused ``w12``
    (``[w1; w2]`` stacked on the output dim) the two up-projections run as
    one GEMM and ``w1``, ``w2`` are not read."""
    if w12 is not None:
        x1, x2 = linear(x, w12.weight, w12.bias, compute_dtype, precision).chunk(2, dim=-1)
    else:
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
