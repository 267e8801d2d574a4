"""DINO/iBOT projection head (port of ``vtp_tpu/models/dino_head.py``).

MLP -> L2 normalize -> weight-normalized projection to the prototypes.
The last layer is stored in decomposed form like torch's ``weight_norm``:
direction ``last_layer.v`` in torch layout (out, in) and gain
``last_layer.g`` (out,); the weight is ``g * v / ||v||`` with the norm over
the input dim. Without weight norm (``use_weight_norm=False``, JAX
:44-48) the last layer is a plain bias-free linear, ``last_layer.weight``.
The MLP linears are ``mlp.layer{i}``. ``head_state_dict`` carries a JAX
head's parameter tree across.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vtp_tpu_torch.models.initializers import linear_, trunc_normal_
from vtp_tpu_torch.ops.activations import gelu_exact
from vtp_tpu_torch.ops.ffn import linear


@dataclasses.dataclass(frozen=True)
class DinoHeadConfig:
    in_dim: int = 768
    out_dim: int = 65536
    nlayers: int = 3
    hidden_dim: int = 2048
    bottleneck_dim: int = 256
    mlp_bias: bool = True
    use_weight_norm: bool = True


class WeightNormLinear(nn.Module):
    """Bias-free linear with weight ``g * v / ||v||_in``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.v = nn.Parameter(torch.empty(out_dim, in_dim))
        self.g = nn.Parameter(torch.empty(out_dim))

    def weight(self) -> torch.Tensor:
        return self.v * (self.g / torch.linalg.vector_norm(self.v, dim=1))[:, None]


class DinoHead(nn.Module):
    def __init__(self, cfg: DinoHeadConfig):
        super().__init__()
        self.cfg = cfg
        n = max(cfg.nlayers, 1)
        dims = ([cfg.in_dim, cfg.bottleneck_dim] if n == 1 else
                [cfg.in_dim] + [cfg.hidden_dim] * (n - 1) + [cfg.bottleneck_dim])
        self.mlp = nn.ModuleDict({f"layer{i}": nn.Linear(dims[i], dims[i + 1], bias=cfg.mlp_bias)
                                  for i in range(n)})
        if cfg.use_weight_norm:
            self.last_layer = WeightNormLinear(cfg.bottleneck_dim, cfg.out_dim)
        else:
            self.last_layer = nn.Linear(cfg.bottleneck_dim, cfg.out_dim, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """trunc_normal(0.02) linears with zero bias; v trunc_normal(0.02), g ones."""
        for lin in self.mlp.values():
            linear_(lin, generator)
        if isinstance(self.last_layer, nn.Linear):
            linear_(self.last_layer, generator)
            return
        trunc_normal_(self.last_layer.v, 0.02, generator)
        nn.init.ones_(self.last_layer.g)

    def forward(self, x: torch.Tensor, *, compute_dtype: Optional[torch.dtype] = None,
                zero_safe_normalize: bool = False) -> torch.Tensor:
        """MLP -> L2 normalize (in fp32 under a compute dtype) -> projection.

        ``zero_safe_normalize`` gives exactly-zero rows a zero Jacobian (the
        clamped normalize has ~1/eps there); values are the same."""
        n = len(self.mlp)
        for i, lin in enumerate(self.mlp.values()):
            x = linear(x, lin.weight, lin.bias, compute_dtype)
            if i < n - 1:
                x = gelu_exact(x)
        eps = 1e-6 if x.dtype == torch.float16 else 1e-12
        if compute_dtype is not None:
            x = x.float()
        sq = (x * x).sum(-1, keepdim=True)
        if zero_safe_normalize:
            is_zero = sq <= eps * eps
            x = torch.where(is_zero, 0.0, x) / torch.sqrt(torch.where(is_zero, 1.0, sq))
        else:
            x = x / torch.clamp(torch.sqrt(torch.clamp(sq, min=eps * eps)), min=eps)
        last = self.last_layer
        w = last.weight if isinstance(last, nn.Linear) else last.weight()
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        return torch.matmul(x, w.t())


def head_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    """A JAX DINO head's parameter tree (numpy arrays: ``mlp.layer{i}``
    kernels (in, out) and biases, ``last_layer`` as ``v`` (in, out) and
    ``g``, or as a plain ``kernel``) -> this module's state dict."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(np.asarray(a, np.float32).T))

    sd = {}
    for name, lin in tree["mlp"].items():
        sd[f"mlp.{name}.weight"] = t(lin["kernel"])
        if lin.get("bias") is not None:
            sd[f"mlp.{name}.bias"] = torch.tensor(np.asarray(lin["bias"], np.float32))
    last = tree["last_layer"]
    if "v" in last:
        sd["last_layer.v"] = t(last["v"])
        sd["last_layer.g"] = torch.tensor(np.asarray(last["g"], np.float32))
    else:
        sd["last_layer.weight"] = t(last["kernel"])
    return sd
