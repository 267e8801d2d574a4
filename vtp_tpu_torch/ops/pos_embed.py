"""2D sin/cos positional embeddings and their resolution interpolation (port
of ``vtp_tpu/ops/pos_embed.py``; reference ``vtp/models/layers/embeddings.py:
198-275``, MAE-style helpers that the shipped VTP models, RoPE only, do not
call).

Layout per position: the feature dim splits into [w-embed | h-embed], each
[sin(pos * omega) | cos(pos * omega)] with omega_k = 10000^(-2k/d).

``interpolate_pos_embed`` resamples as ``jax.image.resize(method="bicubic")``
does (``vtp_tpu/ops/pos_embed.py:64-66``), written out as one weight matrix
an axis: the Keys cubic with a = -0.5, half-pixel centres, each output's
weights renormalised to sum to 1 (so the border renormalises rather than
clamps), and, when an axis shrinks, the kernel stretched by the inverse
scale (antialiasing). ``F.interpolate(mode="bicubic")`` computes another
function (a = -0.75, clamped borders, no antialias) and is not used.
"""

from __future__ import annotations

from typing import Optional

import torch


def sincos_1d(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """(M,) positions -> (M, embed_dim) fp32 as [sin | cos] halves."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    pos = torch.as_tensor(pos)
    k = torch.arange(embed_dim // 2, dtype=torch.float64, device=pos.device) / (embed_dim / 2.0)
    omega = 1.0 / 10000.0 ** k
    angles = pos.reshape(-1).to(torch.float64)[:, None] * omega[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=1).float()


def sincos_2d(embed_dim: int, grid_size: int, cls_token: bool = False,
              device=None) -> torch.Tensor:
    """(grid² [+1], embed_dim) table, row-major over (h, w); the reference's
    xy-indexed meshgrid puts the fast-varying w coordinate in the first
    half (embeddings.py:210-215). ``cls_token`` prepends a zero row."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    coords = torch.arange(grid_size, dtype=torch.float32, device=device)
    hh, ww = torch.meshgrid(coords, coords, indexing="ij")
    emb = torch.cat([sincos_1d(embed_dim // 2, ww), sincos_1d(embed_dim // 2, hh)], dim=1)
    if cls_token:
        emb = torch.cat([torch.zeros((1, embed_dim), device=emb.device), emb], dim=0)
    return emb


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic convolution kernel at a = -0.5, for x >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, far, near))


def bicubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) fp32 resampling matrix of one axis, as
    ``jax.image.resize``'s ``compute_weight_mat`` with the cubic kernel,
    antialiased (the kernel stretched by in/out) when the axis shrinks."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float64, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float64, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).float()


def interpolate_pos_embed(pos_embed: torch.Tensor, new_grid_size: int,
                          num_extra_tokens: Optional[int] = None) -> torch.Tensor:
    """Bicubic-resample a learned ``(B, n_extra + g², D)`` positional table
    to a new grid size, keeping the extra (cls / register) rows as they are
    (embeddings.py:257-275). Returned unchanged when the size already
    matches."""
    n_total, d = pos_embed.shape[-2], pos_embed.shape[-1]
    if num_extra_tokens is None:
        g = int(n_total ** 0.5)
        num_extra_tokens = n_total - g * g
    orig = int((n_total - num_extra_tokens) ** 0.5)
    if orig == new_grid_size:
        return pos_embed
    extra = pos_embed[:, :num_extra_tokens]
    grid = pos_embed[:, num_extra_tokens:].reshape(-1, orig, orig, d)
    w = bicubic_weights(orig, new_grid_size, pos_embed.device)
    out = torch.einsum("bhwd,hH,wW->bHWd", grid.float(), w, w).to(pos_embed.dtype)
    return torch.cat([extra, out.reshape(out.shape[0], new_grid_size * new_grid_size, d)], dim=1)
