"""Scaled dot-product attention: ``sdpa_reference``, written out (port of
``vtp_tpu/ops/attention.py:23``), and ``sdpa``, the dispatcher (:54).

fp32 scores and softmax, probabilities cast to the value dtype before
the PV product, which accumulates in fp32. This is the explicit-math
oracle; ``F.scaled_dot_product_attention`` rounds differently and is not
used by the port. ``precision="high"`` takes both products as the bf16x3
split (``ops/precision.py``).

``sdpa`` routes as the JAX dispatcher does: with no bias and no causal mask,
and when ``flash_supported`` holds (bf16, one shape, head dim 32/64/128),
to ``flash_attention`` (its kernel on the card, its plain version on the
CPU); otherwise to ``sdpa_reference``. The predicate alone picks the
route, on either device; a kernel failure raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from vtp_tpu_torch.ops.precision import check_precision, matmul_high_reference


def sdpa_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    n_valid: int = 0,
    precision: str = "float32",
) -> torch.Tensor:
    """Attention over ``(B, heads, N, head_dim)`` tensors.

    bias: optional additive mask broadcastable to ``(B, heads, Nq, Nk)``.
    n_valid: when nonzero, key columns ``>= n_valid`` are masked.
    """
    check_precision(precision)
    matmul = matmul_high_reference if precision == "high" else torch.matmul
    scale = q.shape[-1] ** -0.5
    # products of bf16 values are exact in fp32, so this is fp32
    # accumulation of the working-dtype operands
    scores = matmul(q.float(), k.float().transpose(-1, -2)) * scale
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
    out = matmul(probs.float(), v.float())
    return out.to(q.dtype)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    is_causal: bool = False,
) -> torch.Tensor:
    """Attention over ``(B, heads, N, head_dim)``: ``flash_attention`` where
    ``flash_supported`` holds and there is no bias, else ``sdpa_reference``."""
    if bias is None:
        from vtp_tpu_torch.ops.flash_attention import flash_attention, flash_supported

        if flash_supported(q, k, v, is_causal=is_causal):
            return flash_attention(q, k, v, is_causal=is_causal)
    return sdpa_reference(q, k, v, bias=bias, is_causal=is_causal)
