"""CLIP-style text transformer (port of ``vtp_tpu/models/text_encoder.py``:
``_text_embeds`` :188, ``_text_block`` :112, ``_pool_project`` :309,
``text_encode`` :338, ``feature_take_indices`` :223,
``text_forward_intermediates`` :236, ``prune_intermediate_layers`` :278).

A pre-LN residual transformer with torch ``nn.MultiheadAttention``
parameter names (fused ``in_proj``). Attention routes as ``_text_block``
(:139-148) does: the plain causal case runs on the fused attention
(``ops/flash_attention.py``: the kernel's causal arm on the card, no
RoPE) where ``fused_attention_supported`` holds, and on the causal
``sdpa_reference`` where it does not (a head dim outside {32, 64, 128},
a one-token text); every other case goes through ``ops/attention.sdpa``, which takes
``flash_attention`` for non-causal unmasked bf16 attention
(``text_no_causal_mask``) on the permuted q, k, v views of the qkv GEMM
output, and ``sdpa_reference`` for the pad-aware additive mask of an
appended cls token.
``text_forward_intermediates`` runs the blocks as ``forward`` does (the
same routes) and keeps the outputs of the layers taken;
``prune_intermediate_layers`` returns a pruned copy and a new config and
leaves the model as it was, as the JAX function returns new params.
Parameter names are the reference checkpoint's (``token_embedding``,
``positional_embedding``, ``text_transformer.resblocks.{i}``,
``ln_final``, ``text_projection``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vtp_tpu_torch.models.blocks import LayerScale, Norm, checkpoint_policy
from vtp_tpu_torch.models.initializers import normal_
from vtp_tpu_torch.ops.activations import ACT
from vtp_tpu_torch.ops.attention import sdpa
from vtp_tpu_torch.ops.ffn import linear
from vtp_tpu_torch.ops.flash_attention import fused_attention_supported, fused_qkv_rope_attention


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 768
    heads: int = 12
    layers: int = 12
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    output_dim: Optional[int] = 768
    embed_cls: bool = False
    no_causal_mask: bool = False
    pad_id: int = 0
    pool_type: str = "argmax"  # first | last | argmax | none
    proj_type: str = "linear"  # linear | none
    proj_bias: bool = False
    quick_gelu: bool = False
    output_tokens: bool = False
    ln_eps: float = 1e-5  # torch nn.LayerNorm default

    @property
    def num_pos(self) -> int:
        return self.context_length + (1 if self.embed_cls else 0)

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def mlp_width(self) -> int:
        return int(self.width * self.mlp_ratio)


class TextAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class TextMlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(width, hidden)
        self.c_proj = nn.Linear(hidden, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.ln_1 = Norm(w, "layernorm", cfg.ln_eps)
        self.attn = TextAttention(w)
        self.ln_2 = Norm(w, "layernorm", cfg.ln_eps)
        self.mlp = TextMlp(w, cfg.mlp_width)
        if cfg.ls_init_value is not None:
            self.ls_1 = LayerScale(w, cfg.ls_init_value)
            self.ls_2 = LayerScale(w, cfg.ls_init_value)
        else:
            self.ls_1 = self.ls_2 = None

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor], is_causal: bool,
                compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
        cfg = self.cfg
        B, L, W = x.shape
        act = ACT["quick_gelu" if cfg.quick_gelu else "gelu"]
        h = self.ln_1(x)
        qkv = linear(h, self.attn.in_proj_weight, self.attn.in_proj_bias, compute_dtype)
        if (is_causal and attn_mask is None
                and fused_attention_supported(qkv.shape, qkv.dtype, cfg.heads)):
            o = fused_qkv_rope_attention(qkv, None, None, cfg.heads, is_causal=True)
        else:
            q, k, v = qkv.reshape(B, L, 3, cfg.heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
            o = sdpa(q, k, v, bias=attn_mask, is_causal=is_causal and attn_mask is None)
            o = o.transpose(1, 2).reshape(B, L, W)
        o = linear(o, self.attn.out_proj.weight, self.attn.out_proj.bias, compute_dtype)
        if self.ls_1 is not None:
            o = self.ls_1(o)
        x = x + o
        h = act(linear(self.ln_2(x), self.mlp.c_fc.weight, self.mlp.c_fc.bias, compute_dtype))
        h = linear(h, self.mlp.c_proj.weight, self.mlp.c_proj.bias, compute_dtype)
        if self.ls_2 is not None:
            h = self.ls_2(h)
        return x + h


class TextStack(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(cfg) for _ in range(cfg.layers))


def causal_mask(n: int, device=None) -> torch.Tensor:
    """Additive float causal mask."""
    return torch.full((n, n), float("-inf"), device=device).triu(1)


def build_cls_mask(text: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Pad-aware additive mask for the appended cls token: only the last
    (cls) query row masks anything; key 0 stays visible and key j > 0
    carries token j-1's pad status. (B, 1, L+1, L+1) fp32."""
    B, L = text.shape
    keys = torch.nn.functional.pad(text != pad_id, (1, 0), value=True)
    cls_row = torch.zeros(keys.shape, dtype=torch.float32, device=text.device)
    cls_row = cls_row.masked_fill(~keys, float("-inf"))
    mask = torch.zeros((B, L + 1, L + 1), dtype=torch.float32, device=text.device)
    mask[:, L, :] = cls_row
    return mask[:, None]


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.num_pos, w))
        self.cls_emb = nn.Parameter(torch.empty(w)) if cfg.embed_cls else None
        self.text_transformer = TextStack(cfg)
        self.ln_final = Norm(w, "layernorm", cfg.ln_eps)
        self.text_projection = None
        if cfg.proj_type != "none" and cfg.output_dim:
            # a bare (width, out) matrix in the reference without a bias, a Linear with one
            self.text_projection = (nn.Linear(w, cfg.output_dim) if cfg.proj_bias else
                                    nn.Parameter(torch.empty(w, cfg.output_dim)))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The OpenAI CLIP init (text_transformer.py:300-321)."""
        cfg = self.cfg
        w = cfg.width
        proj_std = w ** -0.5 * (2 * cfg.layers) ** -0.5
        normal_(self.token_embedding.weight, 0.02, generator)
        normal_(self.positional_embedding, 0.01, generator)
        for blk in self.text_transformer.resblocks:
            normal_(blk.attn.in_proj_weight, w ** -0.5, generator)
            nn.init.zeros_(blk.attn.in_proj_bias)
            normal_(blk.attn.out_proj.weight, proj_std, generator)
            nn.init.zeros_(blk.attn.out_proj.bias)
            normal_(blk.mlp.c_fc.weight, (2 * w) ** -0.5, generator)
            nn.init.zeros_(blk.mlp.c_fc.bias)
            normal_(blk.mlp.c_proj.weight, proj_std, generator)
            nn.init.zeros_(blk.mlp.c_proj.bias)
            for m in (blk.ln_1, blk.ln_2, blk.ls_1, blk.ls_2):
                if m is not None:
                    m.reset_parameters()
        self.ln_final.reset_parameters()
        if self.cls_emb is not None:
            normal_(self.cls_emb, 0.01, generator)
        if isinstance(self.text_projection, nn.Linear):
            normal_(self.text_projection.weight, w ** -0.5, generator)
            nn.init.zeros_(self.text_projection.bias)
        elif self.text_projection is not None:
            normal_(self.text_projection, w ** -0.5, generator)

    def embeds(self, text: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor], bool]:
        """Token embeddings (+ the appended cls token) and the attention
        mask: (x, mask, is_causal); the plain causal case carries no mask."""
        cfg = self.cfg
        B, L = text.shape
        x = self.token_embedding.weight[text]
        if cfg.embed_cls:
            seq = L + 1
            x = torch.cat([x, self.cls_emb.to(x.dtype).expand(B, 1, cfg.width)], dim=1)
            mask = None
            if not cfg.no_causal_mask:
                mask = (causal_mask(cfg.num_pos, text.device)[None, None, :seq, :seq]
                        + build_cls_mask(text, cfg.pad_id)[:, :, :seq, :seq])
            return x + self.positional_embedding[:seq], mask, False
        return x + self.positional_embedding[:L], None, not cfg.no_causal_mask

    def pool_project(self, x: torch.Tensor, text: torch.Tensor,
                     compute_dtype: Optional[torch.dtype]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final norm + pool + projection: (pooled, tokens). With embed_cls the
        pool is the appended token and ln_final applies to it alone."""
        cfg = self.cfg
        if cfg.embed_cls:
            pooled, tokens = self.ln_final(x[:, -1]), x[:, :-1]
        else:
            x = self.ln_final(x)
            tokens = x
            if cfg.pool_type == "first":
                pooled = x[:, 0]
            elif cfg.pool_type == "last":
                pooled = x[:, -1]
            elif cfg.pool_type == "argmax":
                # the first index of the largest token id (the EOT token)
                pooled = x[torch.arange(x.shape[0], device=x.device), text.argmax(-1)]
            else:
                pooled = x
        proj = self.text_projection
        if isinstance(proj, nn.Linear):
            pooled = linear(pooled, proj.weight, proj.bias, compute_dtype)
        elif proj is not None:
            pooled = linear(pooled, proj.t(), None, compute_dtype)
        return pooled, tokens

    def forward(self, text: torch.Tensor, *, normalize: bool = False,
                compute_dtype: Optional[torch.dtype] = None,
                remat: Union[bool, str] = False):
        """Token ids (B, L) -> pooled, projected features; ``(pooled, tokens)``
        when ``output_tokens`` is set. ``remat=True`` recomputes each block
        in the backward (``torch.utils.checkpoint``)."""
        x, mask, is_causal = self.embeds(text)
        use_ckpt = checkpoint_policy(remat)
        for blk in self.text_transformer.resblocks:
            if use_ckpt and torch.is_grad_enabled():
                x = checkpoint(blk, x, mask, is_causal, compute_dtype, use_reentrant=False)
            else:
                x = blk(x, mask, is_causal, compute_dtype)
        pooled, tokens = self.pool_project(x, text, compute_dtype)
        if normalize:
            pooled = pooled / torch.clamp(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True),
                                          min=1e-12)
        if self.cfg.output_tokens:
            return pooled, tokens
        return pooled



def feature_take_indices(num_layers: int,
                         indices: Optional[Union[int, Sequence[int]]]) -> Tuple[List[int], int]:
    """Resolve an intermediate-layer selection (reference
    models/utils/text_utils.py:113-151): None -> every layer, an int n ->
    the last n layers, a sequence -> those layers with negative indices
    wrapped. Returns (take, max(take))."""
    if indices is None:
        indices = num_layers
    if isinstance(indices, int):
        take = list(range(num_layers - indices, num_layers))
    else:
        take = [i if i >= 0 else num_layers + i for i in indices]
    return take, max(take)


def text_forward_intermediates(model: TextTransformer, text: torch.Tensor,
                               indices: Optional[Union[int, Sequence[int]]] = None, *,
                               normalize_intermediates: bool = False,
                               intermediates_only: bool = False,
                               output_extra_tokens: bool = False,
                               compute_dtype: Optional[torch.dtype] = None
                               ) -> Dict[str, Union[torch.Tensor, List[torch.Tensor]]]:
    """The text tower with the outputs of the layers ``indices`` selects
    (text_transformer.py:363-413): {"text_intermediates": [(B, L, W)],
    "text_features": pooled and projected (unless ``intermediates_only``),
    "text_intermediates_suffix": [(B, 1, W)] (with ``embed_cls`` and
    ``output_extra_tokens``: the appended cls slot split off each
    intermediate)}. ``normalize_intermediates`` applies ``ln_final`` to each."""
    cfg = model.cfg
    take, _ = feature_take_indices(cfg.layers, indices)
    x, mask, is_causal = model.embeds(text)
    outs = []
    for blk in model.text_transformer.resblocks:
        x = blk(x, mask, is_causal, compute_dtype)
        outs.append(x)
    inter = [outs[i] for i in take]
    if normalize_intermediates:
        inter = [model.ln_final(t) for t in inter]
    out: Dict[str, Union[torch.Tensor, List[torch.Tensor]]] = {}
    if cfg.embed_cls:
        if output_extra_tokens:
            out["text_intermediates_suffix"] = [t[:, -1:] for t in inter]
        inter = [t[:, :-1] for t in inter]
    out["text_intermediates"] = inter
    if not intermediates_only:
        out["text_features"] = model.pool_project(x, text, compute_dtype)[0]
    return out


def prune_intermediate_layers(model: TextTransformer,
                              indices: Optional[Union[int, Sequence[int]]] = 1, *,
                              prune_norm: bool = False, prune_head: bool = True
                              ) -> Tuple[TextTransformer, TextConfig, List[int]]:
    """A copy of the tower without the layers past the last one ``indices``
    takes (text_transformer.py:415-427); ``prune_norm`` resets ``ln_final``
    to the identity (ones and zeros), ``prune_head`` drops the projection.
    Returns ``(pruned_model, pruned_cfg, take)``; ``model`` is unchanged."""
    cfg = model.cfg
    take, max_index = feature_take_indices(cfg.layers, indices)
    keep = max_index + 1
    pruned = copy.deepcopy(model)
    pruned.cfg = dataclasses.replace(cfg, layers=keep)
    pruned.text_transformer.resblocks = pruned.text_transformer.resblocks[:keep]
    if prune_norm:
        with torch.no_grad():
            pruned.ln_final.reset_parameters()
    if prune_head:
        pruned.text_projection = None
    return pruned, pruned.cfg, take
