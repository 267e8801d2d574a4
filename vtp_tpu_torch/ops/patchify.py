"""Patch embedding and pixel shuffle as reshape + GEMM (port of
``vtp_tpu/ops/patchify.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from vtp_tpu_torch.ops.ffn import linear


def extract_patches(images: torch.Tensor, patch: int) -> torch.Tensor:
    """``(B, C, H, W) -> (B, H/p * W/p, C*p*p)`` with the feature order of
    ``conv_weight.reshape(D, C*p*p)`` (channel-major, then the p×p window
    row-major)."""
    B, C, H, W = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, C, gh, patch, gw, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, gh * gw, C * patch * patch)


def patchify(
    images: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    patch: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Patch embedding ``(B, C, H, W) -> (B, N, D)`` as one GEMM.

    weight: the conv weight ``(D, C, p, p)``; the GEMM is ``ops.ffn.linear``'s."""
    return linear(extract_patches(images, patch), weight.reshape(weight.shape[0], -1), bias,
                  compute_dtype)


def pixel_shuffle(x: torch.Tensor, upscale: int) -> torch.Tensor:
    """``(B, C*r^2, H, W) -> (B, C, H*r, W*r)``:
    out[b, c, h*r+i, w*r+j] = in[b, (c*r + i)*r + j, h, w]."""
    B, Cr2, H, W = x.shape
    r = upscale
    C = Cr2 // (r * r)
    x = x.reshape(B, C, r, r, H, W).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, C, H * r, W * r)


def patch_tokens_to_4d(patch_tokens: torch.Tensor, feat_h: int, feat_w: int) -> torch.Tensor:
    """``(B, N, C) -> (B, C, H', W')`` (modeling_vtp.py:379-395)."""
    B, N, C = patch_tokens.shape
    if N != feat_h * feat_w:
        raise ValueError(f"Patch count mismatch: {N} vs {feat_h * feat_w}")
    return patch_tokens.transpose(1, 2).reshape(B, C, feat_h, feat_w)
