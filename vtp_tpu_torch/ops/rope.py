"""Axial 2-D rotary position embeddings, DINOv3 convention (port of
``vtp_tpu/ops/rope.py``).

For head dim ``Dh`` there are ``P = Dh // 4`` periods. Per token the
angle vector is ``[h*p0..h*pP, w*p0..w*pP]`` tiled twice to length
``Dh``; rotation is rotate-half (``x -> [-x2, x1]``, split at Dh/2).

Tables are built in the rope dtype (bf16 for released checkpoints) with
the same op-by-op rounding as the JAX package, so they are bit-identical
to it. q/k are rotated in that dtype and cast back.

The train-time coordinate augmentations (``rope_sincos`` :58-126:
shift, log-uniform jitter per axis, log-uniform rescale) take their
factors from the caller: drawn by ``draw_rope_coords`` from a
``torch.Generator``, or the JAX package's draws in the tests.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

ROPE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def rope_periods_init(
    head_dim: int,
    base: Optional[float] = 100.0,
    min_period: Optional[float] = None,
    max_period: Optional[float] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> torch.Tensor:
    """Period table of shape ``(head_dim // 4,)`` (embeddings.py:182-195)."""
    quarter = head_dim // 4
    if base is not None:
        idx = torch.arange(quarter, dtype=torch.float32, device=device)
        periods = torch.tensor(base, dtype=torch.float32, device=device) ** (
            2.0 * idx / (head_dim // 2))
    else:
        if min_period is None or max_period is None:
            raise ValueError("Either base or min_period+max_period required")
        ratio = max_period / min_period
        exponents = torch.linspace(0.0, 1.0, quarter, dtype=torch.float32, device=device)
        periods = (ratio ** exponents) / ratio * max_period
    return periods.to(dtype)


def _normalized_coords(n: int, denom: int, dtype: torch.dtype, device) -> torch.Tensor:
    c = (torch.arange(n, dtype=torch.float32, device=device) + 0.5).to(dtype)
    return c / denom


def draw_rope_coords(generator: torch.Generator, shift_coords: Optional[float] = None,
                     jitter_coords: Optional[float] = None,
                     rescale_coords: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One crop's augmentation factors, fp32 on the generator's device, for
    each augmentation configured, in the JAX package's order: ``shift``
    (2,) uniform in [-shift, shift]; ``jitter`` (2,) and ``rescale`` (1,),
    exp of a uniform in [-log j, log j]."""
    kw = dict(generator=generator, device=generator.device, dtype=torch.float32)
    out = {}
    if shift_coords is not None:
        out["shift"] = (2 * torch.rand(2, **kw) - 1) * shift_coords
    if jitter_coords is not None:
        out["jitter"] = torch.exp((2 * torch.rand(2, **kw) - 1) * math.log(jitter_coords))
    if rescale_coords is not None:
        out["rescale"] = torch.exp((2 * torch.rand(1, **kw) - 1) * math.log(rescale_coords))
    return out


def rope_sincos(
    periods: torch.Tensor,
    H: int,
    W: int,
    *,
    normalize_coords: str = "separate",
    shift_coords: Optional[float] = None,
    jitter_coords: Optional[float] = None,
    rescale_coords: Optional[float] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sin, cos)`` tables of shape ``(H*W, head_dim)`` in the periods'
    dtype. With ``draws`` (a training forward's factors, as
    ``draw_rope_coords`` gives them), each configured augmentation applies:
    the fp32 factor is cast to the rope dtype, then the coordinates are
    shifted, jittered per axis and rescaled, each op in that dtype."""
    dtype, device = periods.dtype, periods.device
    if normalize_coords == "max":
        d = max(H, W)
        ch, cw = _normalized_coords(H, d, dtype, device), _normalized_coords(W, d, dtype, device)
    elif normalize_coords == "min":
        d = min(H, W)
        ch, cw = _normalized_coords(H, d, dtype, device), _normalized_coords(W, d, dtype, device)
    elif normalize_coords == "separate":
        ch, cw = _normalized_coords(H, H, dtype, device), _normalized_coords(W, W, dtype, device)
    else:
        raise ValueError(f"Unknown normalize_coords: {normalize_coords}")

    grid_h, grid_w = torch.meshgrid(ch, cw, indexing="ij")
    coords = torch.stack([grid_h, grid_w], dim=-1).reshape(H * W, 2)
    coords = 2.0 * coords - 1.0  # [0,1] -> [-1,1]
    if draws is not None:
        if shift_coords is not None:
            coords = coords + draws["shift"].to(device, dtype)[None, :]
        if jitter_coords is not None:
            coords = coords * draws["jitter"].to(device, dtype)[None, :]
        if rescale_coords is not None:
            coords = coords * draws["rescale"].to(device, dtype)
    # each op computes in fp32 with the full-precision 2*pi and rounds
    # to the rope dtype, as the reference does
    angles = (coords[:, :, None].float() * (2.0 * math.pi)).to(dtype)
    angles = (angles.float() / periods[None, None, :].float()).to(dtype)
    angles = angles.reshape(H * W, -1).tile(1, 2)
    sin = torch.sin(angles.float()).to(dtype)
    cos = torch.cos(angles.float()).to(dtype)
    return sin, cos


def rope_rotate_half(x: torch.Tensor) -> torch.Tensor:
    """``[x1, x2] -> [-x2, x1]`` split at the midpoint of the last dim."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_apply(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    return x * cos + rope_rotate_half(x) * sin


def pad_rope_prefix(sin: torch.Tensor, cos: torch.Tensor,
                    prefix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extend (HW, D) tables to (prefix+HW, D) with the identity rotation
    (sin=0, cos=1) for the cls/storage prefix."""
    if prefix == 0:
        return sin, cos
    zeros = sin.new_zeros((prefix, sin.shape[-1]))
    ones = cos.new_ones((prefix, cos.shape[-1]))
    return torch.cat([zeros, sin]), torch.cat([ones, cos])
