"""Scaled dot-product attention, written out (port of
``vtp_tpu/ops/attention.py:23`` ``sdpa_reference``).

fp32 scores and softmax, probabilities cast to the value dtype before
the PV product, which accumulates in fp32. This is the explicit-math
oracle; ``F.scaled_dot_product_attention`` rounds differently and is not
used by the port.
"""

from __future__ import annotations

from typing import Optional

import torch


def sdpa_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    n_valid: int = 0,
) -> torch.Tensor:
    """Attention over ``(B, heads, N, head_dim)`` tensors.

    bias: optional additive mask broadcastable to ``(B, heads, Nq, Nk)``.
    n_valid: when nonzero, key columns ``>= n_valid`` are masked.
    """
    scale = q.shape[-1] ** -0.5
    # products of bf16 values are exact in fp32, so this is fp32
    # accumulation of the working-dtype operands
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    nq, nk = scores.shape[-2], scores.shape[-1]
    if n_valid and n_valid != nk:
        col = torch.arange(nk, device=scores.device)
        scores = scores.masked_fill(col >= n_valid, float("-inf"))
    if is_causal:
        keep = torch.ones((nq, nk), dtype=torch.bool, device=scores.device).tril(nk - nq)
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), v.float())
    return out.to(q.dtype)
