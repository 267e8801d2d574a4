"""DINOv3-style pre-norm transformer blocks (port of
``vtp_tpu/models/blocks.py``: ``attention_apply`` :153, ``block_apply``
:357, ``scan_blocks`` :547).

Parameter names follow the reference checkpoints (``norm1``,
``attn.qkv``, ``attn.proj``, ``mlp.w1``..., ``ls1.gamma``), so a
released state dict loads by name. The depth loop is a plain loop over
an ``nn.ModuleList``. Multi-crop packing, drop-path and rematerialisation
belong to training and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vtp_tpu_torch.models.initializers import linear_
from vtp_tpu_torch.ops.activations import ACT
from vtp_tpu_torch.ops.ffn import ffn_align_to, linear, mlp, swiglu, swiglu_hidden_dim
from vtp_tpu_torch.ops.flash_attention import fused_qkv_rope_attention
from vtp_tpu_torch.ops.norms import apply_norm, norm_eps

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    dim: int
    num_heads: int
    ffn_ratio: float = 4.0
    ffn_layer: str = "swiglu"  # mlp | swiglu | swiglu32 | swiglu64 | swiglu128
    norm_kind: str = "rmsnorm"  # layernorm | layernormbf16 | rmsnorm
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    layerscale_init: Optional[float] = None
    use_qk_norm: bool = False
    mask_k_bias: bool = False  # LinearKMaskedBias (attention.py:26-38)
    act: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def ffn_hidden(self) -> int:
        if self.ffn_layer == "mlp":
            return int(self.dim * self.ffn_ratio)
        return swiglu_hidden_dim(self.dim, self.ffn_ratio, ffn_align_to(self.ffn_layer))


class Norm(nn.Module):
    """RMSNorm (weight only) or LayerNorm (weight and bias), fp32 stats."""

    def __init__(self, dim: int, kind: str):
        super().__init__()
        self.kind, self.eps = kind, norm_eps(kind)
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim)) if kind != "rmsnorm" else None

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.weight, self.bias, self.kind, self.eps)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.empty(dim))

    def reset_parameters(self) -> None:
        nn.init.constant_(self.gamma, self.init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Attention(nn.Module):
    """qkv GEMM, fused qkv-split + qk-norm + RoPE + attention, out-proj
    (attention_apply)."""

    def __init__(self, cfg: BlockConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.qkv = nn.Linear(d, 3 * d, bias=cfg.qkv_bias)
        self.proj = nn.Linear(d, d, bias=cfg.proj_bias)
        if cfg.use_qk_norm:
            self.q_norm = Norm(cfg.head_dim, "rmsnorm")
            self.k_norm = Norm(cfg.head_dim, "rmsnorm")

    def qkv_bias(self) -> Optional[torch.Tensor]:
        bias = self.qkv.bias
        if self.cfg.mask_k_bias and bias is not None:
            # LinearKMaskedBias: the K third of the bias is zeroed every forward
            d = self.cfg.dim
            keep = torch.ones_like(bias)
            keep[d:2 * d] = 0
            bias = bias * keep
        return bias

    def forward(self, x: torch.Tensor, rope: Rope, n_valid: int = 0,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        cfg = self.cfg
        qkv = linear(x, self.qkv.weight, self.qkv_bias(), compute_dtype)
        o = fused_qkv_rope_attention(
            qkv,
            rope[0] if rope is not None else None,
            rope[1] if rope is not None else None,
            cfg.num_heads,
            q_scale=self.q_norm.weight if cfg.use_qk_norm else None,
            k_scale=self.k_norm.weight if cfg.use_qk_norm else None,
            n_valid=n_valid,
        )
        return linear(o, self.proj.weight, self.proj.bias, compute_dtype)


class SwiGLUFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden, bias=bias)
        self.w2 = nn.Linear(dim, hidden, bias=bias)
        self.w3 = nn.Linear(hidden, dim, bias=bias)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return swiglu(x, self.w1, self.w2, self.w3, compute_dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, bias: bool, act: str):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(dim, hidden, bias=bias)
        self.fc2 = nn.Linear(hidden, dim, bias=bias)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return mlp(x, self.fc1, self.fc2, ACT[self.act], compute_dtype)


class Block(nn.Module):
    """Pre-norm block: ``x + ls1(attn(norm1 x)); x + ls2(ffn(norm2 x))``
    (block_apply)."""

    def __init__(self, cfg: BlockConfig):
        super().__init__()
        self.norm1 = Norm(cfg.dim, cfg.norm_kind)
        self.attn = Attention(cfg)
        self.norm2 = Norm(cfg.dim, cfg.norm_kind)
        if cfg.ffn_layer == "mlp":
            self.mlp = Mlp(cfg.dim, cfg.ffn_hidden, cfg.ffn_bias, cfg.act)
        else:
            self.mlp = SwiGLUFFN(cfg.dim, cfg.ffn_hidden, cfg.ffn_bias)
        if cfg.layerscale_init is not None:
            self.ls1 = LayerScale(cfg.dim, cfg.layerscale_init)
            self.ls2 = LayerScale(cfg.dim, cfg.layerscale_init)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor, rope: Rope, n_valid: int = 0,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        a = self.attn(self.norm1(x), rope, n_valid, compute_dtype)
        x = x + (self.ls1(a) if self.ls1 is not None else a)
        f = self.mlp(self.norm2(x), compute_dtype)
        return x + (self.ls2(f) if self.ls2 is not None else f)


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor, rope: Rope, n_valid: int = 0,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The depth loop (scan_blocks, inference arm)."""
    for blk in blocks:
        x = blk(x, rope, n_valid, compute_dtype)
    return x


def reset_block_parameters(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """The reference init of every block under ``module``: linears
    trunc_normal(0.02) with zero bias, norms ones/zeros, LayerScale at its
    init value."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            linear_(m, generator)
        elif isinstance(m, (Norm, LayerScale)):
            m.reset_parameters()
