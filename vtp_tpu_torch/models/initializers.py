"""Parameter initializers matching the reference's init schemes (port of
``vtp_tpu/models/initializers.py``), each driven by an explicit
``torch.Generator`` on the tensor's device. The draws differ from
``jax.random`` for the same seed; the distributions are the same."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """timm-style truncated normal, cut at ±2σ."""
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def normal_(t: torch.Tensor, std: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return nn.init.normal_(t, 0.0, std, generator=generator)


def patch_embed_uniform_(t: torch.Tensor, in_chans: int, patch: int,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-√k, √k) with k = 1/(C·p²) (embeddings.py:79-83)."""
    bound = math.sqrt(1.0 / (in_chans * patch * patch))
    return nn.init.uniform_(t, -bound, bound, generator=generator)


def linear_(layer: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Every reference tower re-inits its linears with trunc_normal(0.02)
    and a zero bias."""
    trunc_normal_(layer.weight, 0.02, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
