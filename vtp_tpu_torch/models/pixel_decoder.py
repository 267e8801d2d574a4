"""Transformer + pixel-shuffle decoder: f16d64 latents -> RGB (port of
``vtp_tpu/models/pixel_decoder.py:90-147``).

The decode of the reference's rFID protocol runs in exact fp32: every
GEMM in full fp32, with TF32 off for cuBLAS and cuDNN while it runs.
``precision="high"`` is the JAX package's bf16x3 decode: every GEMM
(``proj_in``, qkv, proj, the FFN, ``proj_out``) and the attention's two
dots take each fp32 operand as bf16 halves hi + lo and sum hi·hi + hi·lo
+ lo·hi in fp32 (``ops/precision.py``, the attention kernel's bf16x3 arm);
TF32 stays off there too, so the splits and all other math are true
fp32. torch's own "high" (single-pass TF32) is a different, coarser mode
and is not a stand-in for it. Training decodes with a ``compute_dtype``
(bf16 GEMMs and attention, fp32 norm statistics), the JAX package's
``compute_dtype`` path, which ignores ``precision``. The 1x1 convolutions
``proj_in`` / ``proj_out`` run as GEMMs on their ``(out, in)`` view, so
``utils.quantization`` quantizes them as the JAX package quantizes its 2-D
kernels (:72-80).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from vtp_tpu_torch.models.blocks import Block, BlockConfig, Norm, reset_block_parameters, run_blocks
from vtp_tpu_torch.models.initializers import linear_
from vtp_tpu_torch.models.vit import RopeEmbed
from vtp_tpu_torch.ops.ffn import linear
from vtp_tpu_torch.ops.patchify import pixel_shuffle
from vtp_tpu_torch.ops.precision import check_precision
from vtp_tpu_torch.ops.rope import rope_sincos
from vtp_tpu_torch.utils.quantization import Int8Weight, gemm_weight


@dataclasses.dataclass(frozen=True)
class PixelDecoderConfig:
    in_chans: int = 64
    out_chans: int = 3
    upscale_factor: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    ffn_ratio: float = 4.0
    ffn_layer: str = "swiglu"
    norm_layer: str = "layernorm"
    layerscale_init: Optional[float] = None
    use_qk_norm: bool = False
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    rope_base: Optional[float] = 100.0
    rope_min_period: Optional[float] = None
    rope_max_period: Optional[float] = None
    rope_normalize_coords: str = "separate"
    rope_dtype: str = "bf16"

    @property
    def block(self) -> BlockConfig:
        return BlockConfig(
            dim=self.embed_dim, num_heads=self.num_heads, ffn_ratio=self.ffn_ratio,
            ffn_layer=self.ffn_layer, norm_kind=self.norm_layer, qkv_bias=self.qkv_bias,
            proj_bias=self.proj_bias, ffn_bias=self.ffn_bias,
            layerscale_init=self.layerscale_init, use_qk_norm=self.use_qk_norm,
        )

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@contextlib.contextmanager
def exact_fp32():
    """Full-fp32 GEMMs and convolutions: TF32 off for cuBLAS and cuDNN,
    restored on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class PixelDecoder(nn.Module):
    cp = None  # the ContextParallel of a parallelized model (parallel.sharding)
    pp = None  # its PipelineParallel

    def __init__(self, cfg: PixelDecoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        # 1x1 convolutions in the checkpoint; run as GEMMs on (B, N, C) tokens
        self.proj_in = nn.Conv2d(cfg.in_chans, d, 1, bias=cfg.proj_bias)
        self.proj_out = nn.Conv2d(d, cfg.out_chans * cfg.upscale_factor ** 2, 1,
                                  bias=cfg.proj_bias)
        self.rope_embed = RopeEmbed(cfg.head_dim, cfg.rope_base, cfg.rope_min_period,
                                    cfg.rope_max_period, cfg.rope_dtype)
        self.blocks = nn.ModuleList(Block(cfg.block) for _ in range(cfg.depth))
        self.norm = Norm(d, cfg.norm_layer)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_block_parameters(self, generator)
        linear_(self.proj_in, generator)
        linear_(self.proj_out, generator)
        self.rope_embed.reset_parameters()

    def forward(self, latents: torch.Tensor, precision: str = "float32", *,
                compute_dtype: Optional[torch.dtype] = None,
                remat: Union[bool, str] = False) -> torch.Tensor:
        """(B, C_in, H', W') latents -> (B, 3, H'*u, W'*u) images: in fp32
        at ``precision`` ("float32", exact, or "high", bf16x3) by default,
        in ``compute_dtype`` when one is given (training).
        ``remat`` is the blocks' gradient-checkpoint policy
        (``blocks.checkpoint_policy``)."""
        check_precision(precision)
        if compute_dtype is not None:
            return self._forward(latents, compute_dtype, remat, "float32")
        if any(isinstance(m, Int8Weight) for m in self.modules()):
            # int8 decoder weights are a serving tier: never the fp32 protocol decode
            raise ValueError("an int8 pixel decoder decodes in a compute_dtype (bf16), "
                             "not in the exact or 'high' fp32 protocol")
        with exact_fp32():
            return self._forward(latents.float(), None, remat, precision)

    def _forward(self, latents: torch.Tensor, compute_dtype: Optional[torch.dtype],
                 remat: Union[bool, str], precision: str) -> torch.Tensor:
        cfg = self.cfg
        B, C, H, W = latents.shape
        x = latents.permute(0, 2, 3, 1).reshape(B, H * W, C)
        x = linear(x, gemm_weight(self.proj_in.weight, "conv"), self.proj_in.bias,
                   compute_dtype, precision)
        rope = rope_sincos(self.rope_embed.periods, H, W, normalize_coords=cfg.rope_normalize_coords)
        (x,) = run_blocks(self.blocks, [x], [rope], None, compute_dtype, remat, precision,
                          cp=self.cp, pp=self.pp)
        x = self.norm(x)
        x = linear(x, gemm_weight(self.proj_out.weight, "conv"), self.proj_out.bias,
                   compute_dtype, precision)
        x = x.transpose(1, 2).reshape(B, -1, H, W)
        return pixel_shuffle(x, cfg.upscale_factor)
