"""Normalization ops with the reference's mixed-precision semantics
(port of ``vtp_tpu/ops/norms.py``).

Statistics are computed in fp32 whatever the input dtype:

  * ``rms_norm``: the normalized value is rounded to the *input* dtype,
    then multiplied by the fp32 weight, so a bf16 input gives an fp32
    result (torch type promotion, as the reference).
  * ``layer_norm``: computed in fp32, cast back to the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
    *,
    restore_dtype: bool = True,
) -> torch.Tensor:
    xf = x.float()
    centered = xf - xf.mean(-1, keepdim=True)
    var = (centered * centered).mean(-1, keepdim=True)
    out = centered * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype) if restore_dtype else out


def apply_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               kind: str, eps: float) -> torch.Tensor:
    """Dispatch on the reference's norm registry names: layernorm /
    layernormbf16 / rmsnorm."""
    if kind == "rmsnorm":
        return rms_norm(x, weight, eps)
    return layer_norm(x, weight, bias, eps)


def norm_eps(kind: str) -> float:
    """Epsilons of the reference registry (vision_transformer.py:30-34)."""
    return {"layernorm": 1e-6, "layernormbf16": 1e-5, "rmsnorm": 1e-5}[kind]
