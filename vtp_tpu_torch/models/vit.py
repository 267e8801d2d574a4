"""DINOv3 vision trunk with the optional feature bottleneck (port of
``vtp_tpu/models/vit.py``: ``prepare_tokens`` :132, ``_rope_for`` :195,
``_final_norms`` :212, ``_apply_bottleneck`` :233,
``vit_forward_features`` :241, ``vit_get_intermediate_layers`` :303).

Patchify is a reshape + GEMM and the RoPE tables are built once per
forward and crop shape. A list of crops (the SSL multi-crop forward) runs
through one packed block stack; ``masks`` swap masked patch tokens for
``mask_token``. The JAX package pads tokens to the TPU's sublane tile;
the port does not, since the CUDA kernel masks keys by bounds. Under
context parallelism ``run_blocks`` pads each crop to a multiple of the seq
axis instead, and slices the padding off after the stack.

In training, ``forward_features`` takes a ``generator`` or ``draws`` where
the JAX forward takes a key: each crop's RoPE coordinate augmentation
(``vit.py:263-271``, a key folded per crop) and, with ``drop_ratio > 0``,
every block's drop-path rows (``scan_blocks`` :590-636). ``sample_draws``
draws them all before the forward, so no draw happens inside a
checkpointed block; a test gives the JAX package's draws instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vtp_tpu_torch.models.blocks import (
    Block,
    BlockConfig,
    Norm,
    Rope,
    draw_drop_indices,
    reset_block_parameters,
    run_blocks,
)
from vtp_tpu_torch.models.initializers import normal_, patch_embed_uniform_, trunc_normal_
from vtp_tpu_torch.ops.ffn import linear
from vtp_tpu_torch.ops.patchify import patchify
from vtp_tpu_torch.ops.rope import (
    ROPE_DTYPES,
    draw_rope_coords,
    pad_rope_prefix,
    rope_periods_init,
    rope_sincos,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    in_chans: int = 3
    ffn_ratio: float = 4.0
    ffn_layer: str = "swiglu"
    norm_layer: str = "rmsnorm"
    layerscale_init: Optional[float] = None
    use_qk_norm: bool = False
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    n_storage_tokens: int = 0
    mask_k_bias: bool = False
    untie_cls_and_patch_norms: bool = False
    untie_global_and_local_cls_norm: bool = False
    feature_bottleneck: Optional[int] = None  # None or == embed_dim -> no bottleneck
    rope_base: Optional[float] = 100.0
    rope_min_period: Optional[float] = None
    rope_max_period: Optional[float] = None
    rope_normalize_coords: str = "separate"
    rope_shift_coords: Optional[float] = None
    rope_jitter_coords: Optional[float] = None
    rope_rescale_coords: Optional[float] = None
    rope_dtype: str = "bf16"
    # the head-major TP layout factor of the qkv parameters (parallel/sharding.py)
    qkv_head_major: int = 1

    @property
    def block(self) -> BlockConfig:
        return BlockConfig(
            dim=self.embed_dim, num_heads=self.num_heads, ffn_ratio=self.ffn_ratio,
            ffn_layer=self.ffn_layer, norm_kind=self.norm_layer, qkv_bias=self.qkv_bias,
            proj_bias=self.proj_bias, ffn_bias=self.ffn_bias,
            layerscale_init=self.layerscale_init, use_qk_norm=self.use_qk_norm,
            mask_k_bias=self.mask_k_bias, qkv_head_major=self.qkv_head_major,
        )

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def has_bottleneck(self) -> bool:
        return self.feature_bottleneck is not None and self.feature_bottleneck != self.embed_dim


class RopeEmbed(nn.Module):
    """Holds the ``periods`` buffer of the reference's RopePositionEmbedding
    (a persistent buffer in the rope dtype; checkpoints carry it)."""

    def __init__(self, head_dim: int, base, min_period, max_period, dtype: str):
        super().__init__()
        self.args = (head_dim, base, min_period, max_period, ROPE_DTYPES[dtype])
        self.register_buffer("periods", torch.empty(head_dim // 4, dtype=ROPE_DTYPES[dtype]))

    def reset_parameters(self) -> None:
        head_dim, base, lo, hi, dtype = self.args
        self.periods.copy_(rope_periods_init(head_dim, base, lo, hi, dtype, self.periods.device))


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, stride=patch)  # weight holder only


class VisionTransformer(nn.Module):
    # the ContextParallel / PipelineParallel of a parallelized model
    # (parallel.sharding.parallelize_model): its block stack's token split
    # over a seq axis, or its stages over a pipe axis
    cp = None
    pp = None

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.in_chans, d, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.mask_token = nn.Parameter(torch.empty(1, d))
        self.storage_tokens = (nn.Parameter(torch.empty(1, cfg.n_storage_tokens, d))
                               if cfg.n_storage_tokens > 0 else None)
        self.rope_embed = RopeEmbed(cfg.head_dim, cfg.rope_base, cfg.rope_min_period,
                                    cfg.rope_max_period, cfg.rope_dtype)
        self.blocks = nn.ModuleList(Block(cfg.block) for _ in range(cfg.depth))
        self.norm = Norm(d, cfg.norm_layer)
        if cfg.untie_cls_and_patch_norms:
            self.cls_norm = Norm(d, cfg.norm_layer)
        if cfg.untie_global_and_local_cls_norm:
            self.local_cls_norm = Norm(d, cfg.norm_layer)
        if cfg.has_bottleneck:
            self.feature_bottleneck = nn.Linear(d, cfg.feature_bottleneck, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        cfg = self.cfg
        reset_block_parameters(self, generator)  # blocks, norms, bottleneck
        pe = self.patch_embed.proj
        patch_embed_uniform_(pe.weight, cfg.in_chans, cfg.patch_size, generator)
        patch_embed_uniform_(pe.bias, cfg.in_chans, cfg.patch_size, generator)
        normal_(self.cls_token, 0.02, generator)
        nn.init.zeros_(self.mask_token)
        if self.storage_tokens is not None:
            normal_(self.storage_tokens, 0.02, generator)
        self.rope_embed.reset_parameters()

    def prepare_tokens(self, images: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                       masks: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """Patchify + [cls | storage | patches]. images: (B, C, H, W);
        masks: optional (B, N) bool, True where a patch is replaced by
        ``mask_token``."""
        cfg = self.cfg
        B, _, H, W = images.shape
        gh, gw = H // cfg.patch_size, W // cfg.patch_size
        pe = self.patch_embed.proj
        x = patchify(images, pe.weight, pe.bias, patch=cfg.patch_size, compute_dtype=compute_dtype)
        if masks is not None:
            x = torch.where(masks[..., None], self.mask_token[None].to(x.dtype), x)
        pieces = [self.cls_token.to(x.dtype).expand(B, 1, cfg.embed_dim)]
        if self.storage_tokens is not None:
            pieces.append(self.storage_tokens.to(x.dtype).expand(B, -1, cfg.embed_dim))
        pieces.append(x)
        return torch.cat(pieces, dim=1), (gh, gw)

    def rope_for(self, gh: int, gw: int, draws: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Rope:
        """The (1 + storage + gh*gw, head_dim) tables; ``draws`` (one crop's
        ``draw_rope_coords``) applies the configured coordinate augmentations."""
        cfg = self.cfg
        sin, cos = rope_sincos(self.rope_embed.periods, gh, gw,
                               normalize_coords=cfg.rope_normalize_coords,
                               shift_coords=cfg.rope_shift_coords,
                               jitter_coords=cfg.rope_jitter_coords,
                               rescale_coords=cfg.rope_rescale_coords, draws=draws)
        return pad_rope_prefix(sin, cos, 1 + cfg.n_storage_tokens)

    def sample_draws(self, generator: torch.Generator, batches: Sequence[int],
                     drop_ratio: float = 0.0, drop_shards: int = 1) -> Dict[str, list]:
        """A training forward's draws for crops of ``batches`` rows: ``rope``,
        each crop's augmentation factors (``draw_rope_coords``), and, with
        ``drop_ratio > 0``, ``drop``, each block's kept rows
        (``draw_drop_indices`` with ``drop_shards``). A data-parallel step
        adds ``drop_scale``, each kept subset's residual scale, when it cuts
        the global subsets to its shard's rows."""
        cfg = self.cfg
        out = {"rope": [draw_rope_coords(generator, cfg.rope_shift_coords, cfg.rope_jitter_coords,
                                         cfg.rope_rescale_coords) for _ in batches]}
        if drop_ratio > 0.0:
            out["drop"] = draw_drop_indices(generator, batches, cfg.depth, drop_ratio,
                                            drop_shards)
        return out

    def final_norms(self, x: torch.Tensor, crop_index: int = 0, training: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cls_reg_normed, patch_normed), with the untied cls norms when
        configured (the local-crop cls norm applies to crop 1 in training)."""
        cfg = self.cfg
        s = cfg.n_storage_tokens + 1
        if cfg.untie_cls_and_patch_norms or cfg.untie_global_and_local_cls_norm:
            if cfg.untie_global_and_local_cls_norm and training and crop_index == 1:
                cls_norm = self.local_cls_norm
            elif cfg.untie_cls_and_patch_norms:
                cls_norm = self.cls_norm
            else:
                cls_norm = self.norm
            return cls_norm(x[:, :s]), self.norm(x[:, s:])
        xn = self.norm(x)
        return xn[:, :s], xn[:, s:]

    def apply_bottleneck(self, t: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
        return linear(t, self.feature_bottleneck.weight, None, compute_dtype)

    def forward_features(
        self,
        images: Union[torch.Tensor, Sequence[torch.Tensor]],
        masks: Union[None, torch.Tensor, Sequence[Optional[torch.Tensor]]] = None,
        *,
        use_bottleneck: bool = True,
        compute_dtype: Optional[torch.dtype] = None,
        training: bool = False,
        remat: Union[bool, str] = False,
        drop_ratio: float = 0.0,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, list]] = None,
    ) -> Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]:
        """The reference's forward_features dict(s): x_norm_clstoken,
        x_storage_tokens, x_norm_patchtokens, x_prenorm, masks. A list of
        crops returns a list. ``training`` selects the local-crop cls norm;
        ``remat`` is the blocks' gradient-checkpoint policy
        (``blocks.checkpoint_policy``). With ``training`` and a ``generator``
        or ``draws`` (``sample_draws``'s, which are drawn from the generator
        when not given), the RoPE coordinates are augmented as configured and,
        with ``drop_ratio > 0``, every block runs drop-path."""
        single = not isinstance(images, (list, tuple))
        x_list = [images] if single else list(images)
        if single:
            masks_list = [masks]
        else:
            masks_list = list(masks) if masks is not None else [None] * len(x_list)
        if not training or (generator is None and draws is None):
            draws = None
        elif draws is None:
            draws = self.sample_draws(generator, [x.shape[0] for x in x_list], drop_ratio)
        xs, ropes = [], []
        for i, (img, m) in enumerate(zip(x_list, masks_list)):
            x, (gh, gw) = self.prepare_tokens(img, compute_dtype, m)
            xs.append(x)
            ropes.append(self.rope_for(gh, gw, draws["rope"][i] if draws is not None else None))
        drop = draws["drop"] if draws is not None and drop_ratio > 0.0 else None
        scales = draws.get("drop_scale") if drop is not None else None
        xs = run_blocks(self.blocks, xs, ropes, None, compute_dtype, remat, drop=drop,
                        drop_scales=scales, cp=self.cp, pp=self.pp)
        outputs = []
        for i, (x, m) in enumerate(zip(xs, masks_list)):
            cls_reg, patch = self.final_norms(x, crop_index=i, training=training)
            out = {"x_norm_clstoken": cls_reg[:, 0], "x_storage_tokens": cls_reg[:, 1:],
                   "x_norm_patchtokens": patch, "x_prenorm": x, "masks": m}
            if use_bottleneck and self.cfg.has_bottleneck:
                out["x_norm_clstoken"] = self.apply_bottleneck(out["x_norm_clstoken"], compute_dtype)
                out["x_norm_patchtokens"] = self.apply_bottleneck(out["x_norm_patchtokens"],
                                                                  compute_dtype)
            outputs.append(out)
        return outputs[0] if single else outputs

    def get_intermediate_layers(
        self,
        images: torch.Tensor,
        n: Union[int, Sequence[int]] = 1,
        *,
        reshape: bool = False,
        return_class_token: bool = False,
        return_extra_tokens: bool = False,
        norm: bool = True,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> Tuple:
        """The outputs of the last ``n`` blocks (or of the blocks whose
        indices ``n`` lists), always bypassing the bottleneck
        (vision_transformer.py:281-318): a tuple of patch tokens, (B, N, D)
        or (B, D, gh, gw) with ``reshape``, each zipped with its class token
        and/or its storage tokens when asked. The blocks after the last
        index taken are not run."""
        cfg = self.cfg
        take = list(range(cfg.depth - n, cfg.depth)) if isinstance(n, int) else sorted(map(int, n))
        x, (gh, gw) = self.prepare_tokens(images, compute_dtype)
        rope = self.rope_for(gh, gw)
        B, N, D = x.shape
        flat, outputs = x.reshape(B * N, D), []
        for i, blk in enumerate(self.blocks[:take[-1] + 1]):
            flat = blk.forward_packed(flat, [(B, N)], [rope], [N], compute_dtype)
            if i in take:
                outputs.append(flat.reshape(B, N, D))
        s = cfg.n_storage_tokens + 1
        if norm:
            if cfg.untie_cls_and_patch_norms:
                outputs = [torch.cat([self.cls_norm(o[:, :s]), self.norm(o[:, s:])], dim=1)
                           for o in outputs]
            else:
                outputs = [self.norm(o) for o in outputs]
        class_tokens = [o[:, 0] for o in outputs]
        extra = [o[:, 1:s] for o in outputs]
        patches = [o[:, s:] for o in outputs]
        if reshape:
            patches = [o.reshape(B, gh, gw, -1).permute(0, 3, 1, 2) for o in patches]
        if return_class_token and return_extra_tokens:
            return tuple(zip(patches, class_tokens, extra))
        if return_class_token:
            return tuple(zip(patches, class_tokens))
        if return_extra_tokens:
            return tuple(zip(patches, extra))
        return tuple(patches)
