"""Auxiliary layers of the reference inventory that the shipped VTP
checkpoints do not use (port of ``vtp_tpu/models/extras.py``):

- ``CausalBlock`` (attention.py:129-174, block.py:311-367);
- ``CustomAttention``, CLIP-style, with the scaled-cosine branch and the
  per-head scale (attention.py:177-273), and ``CustomResidualAttentionBlock``
  / ``CustomTransformer`` on it (block.py:430-476, text_transformer.py:111-210);
- ``AttentionalPooler`` (attention.py:276-301);
- ``patch_dropout`` (misc.py:29-71);
- ``MultimodalCrossBlock`` and ``MultimodalTransformer``
  (text_transformer.py:455-561).

A top-level module allocates its parameters on ``device`` (``cuda``
unless the caller asks for the CPU) without initialising them:
``reset_parameters(generator)`` draws them as the JAX ``init_*`` functions
do (the same distributions, not the same draws), and ``load_jax`` loads the
JAX package's parameters (a dict of numpy arrays, ``kernel`` (in, out)
transposed to the torch layout; a depth-stacked stack gives layer ``i``
its slice of the leading axis).

Attention routes as the JAX ``sdpa`` does (``vtp_tpu/ops/attention.py:54-73``,
mirrored by ``ops/attention.sdpa``): same-shape bf16 q, k, v without a bias
take ``flash_attention`` (its kernel on the card); cross-attention, masks and
fp32 take ``sdpa_reference``; the scaled-cosine branch is the plain product,
as in JAX. ``MultimodalTransformer``'s self-attention hands the text block
the causal mask as a bias with ``is_causal`` False
(``multimodal_transformer_forward``), so it takes the plain path and never
the fused kernel, as in JAX. Where JAX multiplies mixed dtypes (a bf16
activation by an fp32 weight) it promotes to fp32, and so do these modules.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from vtp_tpu_torch.models.blocks import LayerScale, Norm
from vtp_tpu_torch.models.initializers import linear_, normal_
from vtp_tpu_torch.models.text_encoder import (
    ResidualAttentionBlock,
    TextAttention,
    TextConfig,
    TextMlp,
    causal_mask,
)
from vtp_tpu_torch.ops.activations import gelu_exact
from vtp_tpu_torch.ops.attention import sdpa
from vtp_tpu_torch.ops.ffn import linear

LN_EPS = 1e-5  # the JAX layer_norm's default, which these layers use


# ---------------------------------------------------------------- loading


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def _load_linear(lin: nn.Linear, p: Mapping) -> None:
    lin.weight.copy_(_tensor(np.asarray(p["kernel"]).T, lin.weight))
    if lin.bias is not None:
        lin.bias.copy_(_tensor(p["bias"], lin.bias))


@torch.no_grad()
def _load_norm(norm: Norm, p: Mapping) -> None:
    norm.weight.copy_(_tensor(p["scale"], norm.weight))
    norm.bias.copy_(_tensor(p["bias"], norm.bias))


@torch.no_grad()
def _load_in_proj(attn: TextAttention, p: Mapping) -> None:
    """A fused (W, 3W) in_proj into nn.MultiheadAttention's names."""
    attn.in_proj_weight.copy_(_tensor(np.asarray(p["in_proj"]["kernel"]).T, attn.in_proj_weight))
    attn.in_proj_bias.copy_(_tensor(p["in_proj"]["bias"], attn.in_proj_bias))
    _load_linear(attn.out_proj, p["out_proj"])


@torch.no_grad()
def _load_scale(ls: Optional[LayerScale], p: Mapping, key: str) -> None:
    if ls is not None:
        ls.gamma.copy_(_tensor(p[key]["gamma"], ls.gamma))


def _layer(tree: Mapping, i: int) -> Mapping:
    """Layer ``i`` of a depth-stacked parameter tree."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)[i]


# ------------------------------------------------------------- helpers


def _linear(x: torch.Tensor, lin: nn.Linear, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``linear``, promoting a bf16 input to the fp32 weight's dtype when no
    compute dtype is given (JAX's promotion of a mixed product)."""
    if compute_dtype is None:
        x = x.to(torch.promote_types(x.dtype, lin.weight.dtype))
    return linear(x, lin.weight, lin.bias, compute_dtype)


def _layer_norm(dim: int) -> Norm:
    return Norm(dim, "layernorm", LN_EPS)


@torch.no_grad()
def _init_linear(lin: nn.Linear, std: float, generator) -> None:
    """N(0, std²) weight, zero bias."""
    normal_(lin.weight, std, generator)
    if lin.bias is not None:
        lin.bias.zero_()


@torch.no_grad()
def _init_norms_and_scales(module: nn.Module) -> None:
    """Every LayerNorm to ones and zeros, every LayerScale to its init value."""
    for m in module.modules():
        if isinstance(m, (Norm, LayerScale)):
            m.reset_parameters()


# ----------------------------------------------------- causal AR block


class CausalAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class CausalMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class CausalBlock(nn.Module):
    """The autoregressive pre-LN block (``causal_block_apply``)."""

    def __init__(self, dim: int, num_heads: int, ffn_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        with torch.device("meta"):
            self.attention_norm = _layer_norm(dim)
            self.attention = CausalAttention(dim)
            self.ffn_norm = _layer_norm(dim)
            self.feed_forward = CausalMlp(dim, int(dim * ffn_ratio))
            self.ls1 = LayerScale(dim, ls_init_value) if ls_init_value is not None else None
            self.ls2 = LayerScale(dim, ls_init_value) if ls_init_value is not None else None
        self.to_empty(device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "CausalBlock":
        """``init_causal_block_params`` (block.py:344-358): attention std
        d^-1/2, fc1 (2d)^-1/2, fc2 d^-1/2, zero biases."""
        d = self.attention.proj.in_features
        _init_norms_and_scales(self)
        _init_linear(self.attention.qkv, d ** -0.5, generator)
        _init_linear(self.attention.proj, d ** -0.5, generator)
        _init_linear(self.feed_forward.fc1, (2 * d) ** -0.5, generator)
        _init_linear(self.feed_forward.fc2, d ** -0.5, generator)
        return self

    @torch.no_grad()
    def load_jax(self, p: Mapping) -> "CausalBlock":
        _load_norm(self.attention_norm, p["attention_norm"])
        _load_linear(self.attention.qkv, p["attention"]["qkv"])
        _load_linear(self.attention.proj, p["attention"]["proj"])
        _load_norm(self.ffn_norm, p["ffn_norm"])
        _load_linear(self.feed_forward.fc1, p["feed_forward"]["fc1"])
        _load_linear(self.feed_forward.fc2, p["feed_forward"]["fc2"])
        _load_scale(self.ls1, p, "ls1")
        _load_scale(self.ls2, p, "ls2")
        return self

    def forward(self, x: torch.Tensor, is_causal: bool = True,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        h = self.attention_norm(x)
        qkv = _linear(h, self.attention.qkv, compute_dtype)
        q, k, v = qkv.reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        o = sdpa(q, k, v, is_causal=is_causal)
        o = _linear(o.transpose(1, 2).reshape(B, N, C), self.attention.proj, compute_dtype)
        if self.ls1 is not None:
            o = self.ls1(o)
        x = x + o
        h = gelu_exact(_linear(self.ffn_norm(x), self.feed_forward.fc1, compute_dtype))
        o = _linear(h, self.feed_forward.fc2, compute_dtype)
        if self.ls2 is not None:
            o = self.ls2(o)
        return x + o


# ------------------------------------- CLIP-style (scaled-cosine) attention


class CustomAttention(nn.Module):
    """Fused in_proj, out_proj; with ``scaled_cosine`` the cosine scores
    times exp(min(logit_scale, log(1 / 0.01))) a head; with ``scale_heads``
    a per-head output scale (``custom_attention_apply``)."""

    def __init__(self, dim: int, num_heads: int, scaled_cosine: bool = False,
                 scale_heads: bool = False, logit_scale_max: float = math.log(1.0 / 0.01),
                 device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.logit_scale_max = logit_scale_max
        with torch.device("meta"):
            self.in_proj = nn.Linear(dim, 3 * dim)
            self.out_proj = nn.Linear(dim, dim)
            self.logit_scale = (nn.Parameter(torch.empty((num_heads, 1, 1))) if scaled_cosine
                                else None)
            self.head_scale = nn.Parameter(torch.empty((num_heads, 1, 1))) if scale_heads else None
        self.to_empty(device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """``init_custom_attention_params``: in_proj N(0, head_dim^-1),
        out_proj trunc_normal(0.02), logit_scale log(10), head_scale 1."""
        dim = self.out_proj.in_features
        _init_linear(self.in_proj, (dim // self.num_heads) ** -0.5, generator)
        linear_(self.out_proj, generator)
        if self.logit_scale is not None:
            self.logit_scale.fill_(math.log(10.0))
        if self.head_scale is not None:
            self.head_scale.fill_(1.0)

    @torch.no_grad()
    def load_jax(self, p: Mapping) -> "CustomAttention":
        _load_linear(self.in_proj, p["in_proj"])
        _load_linear(self.out_proj, p["out_proj"])
        for name in ("logit_scale", "head_scale"):
            if getattr(self, name) is not None:
                getattr(self, name).copy_(_tensor(p[name], getattr(self, name)))
        return self

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        B, L, C = x.shape
        hd = C // self.num_heads
        qkv = _linear(x, self.in_proj, compute_dtype)
        q, k, v = (t.reshape(B, L, self.num_heads, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        if self.logit_scale is not None:
            qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
            kn = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp(min=1e-12)
            scores = torch.matmul(qn.float(), kn.float().transpose(-1, -2))
            scores = scores * torch.exp(self.logit_scale.clamp(max=self.logit_scale_max))[None]
            if attn_mask is not None:
                scores = scores + attn_mask
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            o = torch.matmul(probs.float(), v.float()).to(x.dtype)
        else:
            o = sdpa(q, k, v, bias=attn_mask)
        if self.head_scale is not None:
            o = o * self.head_scale[None]
        o = o.transpose(1, 2).reshape(B, L, C)
        return _linear(o, self.out_proj, compute_dtype)


class CustomMlp(nn.Module):
    def __init__(self, dim: int, hidden: int, scale_fc: bool):
        super().__init__()
        self.c_fc = nn.Linear(dim, hidden)
        self.ln = _layer_norm(hidden) if scale_fc else None
        self.c_proj = nn.Linear(hidden, dim)


class CustomResidualAttentionBlock(nn.Module):
    """``custom_resblock_apply``: the scaled-cosine attention core with an
    optional post-attention norm (``scale_attn``) and mid-MLP norm
    (``scale_fc``), and optional LayerScale."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, scale_cosine_attn: bool = False,
                 scale_heads: bool = False, scale_attn: bool = False, scale_fc: bool = False,
                 device="cuda"):
        super().__init__()
        with torch.device("meta"):
            self.ln_1 = _layer_norm(dim)
            self.attn = CustomAttention(dim, num_heads, scale_cosine_attn, scale_heads,
                                        device="meta")
            self.ln_attn = _layer_norm(dim) if scale_attn else None
            self.ln_2 = _layer_norm(dim)
            self.mlp = CustomMlp(dim, int(dim * mlp_ratio), scale_fc)
            self.ls_1 = LayerScale(dim, ls_init_value) if ls_init_value is not None else None
            self.ls_2 = LayerScale(dim, ls_init_value) if ls_init_value is not None else None
        self.to_empty(device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> "CustomResidualAttentionBlock":
        """``init_custom_resblock_params``: the attention's init, the MLP's
        linears trunc_normal(0.02) with zero biases."""
        _init_norms_and_scales(self)
        self.attn.reset_parameters(generator)
        linear_(self.mlp.c_fc, generator)
        linear_(self.mlp.c_proj, generator)
        return self

    @torch.no_grad()
    def load_jax(self, p: Mapping) -> "CustomResidualAttentionBlock":
        _load_norm(self.ln_1, p["ln_1"])
        self.attn.load_jax(p["attn"])
        if self.ln_attn is not None:
            _load_norm(self.ln_attn, p["ln_attn"])
        _load_norm(self.ln_2, p["ln_2"])
        _load_linear(self.mlp.c_fc, p["mlp"]["c_fc"])
        if self.mlp.ln is not None:
            _load_norm(self.mlp.ln, p["mlp"]["ln"])
        _load_linear(self.mlp.c_proj, p["mlp"]["c_proj"])
        _load_scale(self.ls_1, p, "ls_1")
        _load_scale(self.ls_2, p, "ls_2")
        return self

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        o = self.attn(self.ln_1(x), attn_mask, compute_dtype)
        if self.ln_attn is not None:
            o = self.ln_attn(o)
        if self.ls_1 is not None:
            o = self.ls_1(o)
        x = x + o
        h = gelu_exact(_linear(self.ln_2(x), self.mlp.c_fc, compute_dtype))
        if self.mlp.ln is not None:
            h = self.mlp.ln(h)
        h = _linear(h, self.mlp.c_proj, compute_dtype)
        if self.ls_2 is not None:
            h = self.ls_2(h)
        return x + h


class CustomTransformer(nn.Module):
    """A stack of ``CustomResidualAttentionBlock`` (``custom_transformer_forward``)."""

    def __init__(self, width: int, layers: int, num_heads: int, device="cuda", **block_kwargs):
        super().__init__()
        self.resblocks = nn.ModuleList(
            CustomResidualAttentionBlock(width, num_heads, device=device, **block_kwargs)
            for _ in range(layers))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "CustomTransformer":
        for blk in self.resblocks:
            blk.reset_parameters(generator)
        return self

    @torch.no_grad()
    def load_jax(self, params: Mapping) -> "CustomTransformer":
        for i, blk in enumerate(self.resblocks):
            blk.load_jax(_layer(params["resblocks"], i))
        return self

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, attn_mask, compute_dtype)
        return x


# ------------------------------------------------- attentional pooler


class AttentionalPooler(nn.Module):
    """Learned-query multi-head attention pooling in fp32
    (``attentional_pooler_apply``): ``n_queries`` queries over (B, N, Ckv)."""

    def __init__(self, d_model: int, context_dim: int, n_head: int = 8, n_queries: int = 256,
                 device="cuda"):
        super().__init__()
        self.n_head = n_head
        with torch.device("meta"):
            self.query = nn.Parameter(torch.empty(n_queries, d_model))
            self.ln_q = _layer_norm(d_model)
            self.ln_k = _layer_norm(context_dim)
            self.q_proj = nn.Linear(d_model, d_model)
            self.k_proj = nn.Linear(context_dim, d_model)
            self.v_proj = nn.Linear(context_dim, d_model)
            self.out_proj = nn.Linear(d_model, d_model)
        self.to_empty(device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "AttentionalPooler":
        """``init_attentional_pooler_params``: queries N(0, 1), projections
        trunc_normal(0.02) with zero biases."""
        _init_norms_and_scales(self)
        normal_(self.query, 1.0, generator)
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.out_proj):
            linear_(lin, generator)
        return self

    @torch.no_grad()
    def load_jax(self, p: Mapping) -> "AttentionalPooler":
        self.query.copy_(_tensor(p["query"], self.query))
        _load_norm(self.ln_q, p["ln_q"])
        _load_norm(self.ln_k, p["ln_k"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _load_linear(getattr(self, name), p[name])
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        d = self.query.shape[-1]
        hd = d // self.n_head
        xk = self.ln_k(x)
        q = self.ln_q(self.query)
        q = _linear(q[None].expand(B, *q.shape), self.q_proj, None)
        k = _linear(xk, self.k_proj, None)
        v = _linear(xk, self.v_proj, None)
        to_heads = lambda t: t.reshape(B, t.shape[1], self.n_head, hd).transpose(1, 2)
        o = sdpa(to_heads(q), to_heads(k), to_heads(v))
        return _linear(o.transpose(1, 2).reshape(B, -1, d), self.out_proj, None)


# ----------------------------------------------------- patch dropout


def patch_dropout_select(x: torch.Tensor, scores: torch.Tensor, prob: float,
                         exclude_first_token: bool = True) -> torch.Tensor:
    """Keep the tokens of the top-k ``scores`` (B, N) (N without the first
    token when it is excluded), k = max(1, int(N (1 - prob))), in top-k
    order, the first token in front."""
    cls = None
    if exclude_first_token:
        cls, x = x[:, :1], x[:, 1:]
    idx = scores.topk(max(1, int(x.shape[1] * (1.0 - prob))), dim=-1).indices
    x = x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return x if cls is None else torch.cat([cls, x], dim=1)


def patch_dropout(x: torch.Tensor, prob: float, exclude_first_token: bool = True,
                  training: bool = True,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keep a random subset of tokens (misc.py:29-71): scores drawn N(0, 1)
    from ``generator`` (on x's device), then ``patch_dropout_select``."""
    if not training or prob == 0.0:
        return x
    n = x.shape[1] - (1 if exclude_first_token else 0)
    scores = torch.randn((x.shape[0], n), generator=generator, device=x.device)
    return patch_dropout_select(x, scores, prob, exclude_first_token)


# ----------------------------------------- multimodal (cross-attention) text


def _promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


class MultimodalCrossBlock(nn.Module):
    """One cross-attention residual block (``multimodal_cross_block``;
    block.py:370-427 with is_cross_attention): q from the text, k and v
    from the image tokens, projected in fp32 (promoted) as JAX does."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        with torch.device("meta"):
            self.ln_1 = _layer_norm(width)
            self.ln_1_kv = _layer_norm(width)
            self.attn = TextAttention(width)
            self.ln_2 = _layer_norm(width)
            self.mlp = TextMlp(width, int(width * mlp_ratio))
            self.ls_1 = LayerScale(width, ls_init_value) if ls_init_value is not None else None
            self.ls_2 = LayerScale(width, ls_init_value) if ls_init_value is not None else None
        self.to_empty(device=device)

    @torch.no_grad()
    def load_jax(self, p: Mapping) -> "MultimodalCrossBlock":
        _load_norm(self.ln_1, p["ln_1"])
        _load_norm(self.ln_1_kv, p["ln_1_kv"])
        _load_in_proj(self.attn, p["attn"])
        _load_norm(self.ln_2, p["ln_2"])
        _load_linear(self.mlp.c_fc, p["mlp"]["c_fc"])
        _load_linear(self.mlp.c_proj, p["mlp"]["c_proj"])
        _load_scale(self.ls_1, p, "ls_1")
        _load_scale(self.ls_2, p, "ls_2")
        return self

    def forward(self, text: torch.Tensor, image: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        B, L, W = text.shape
        hd = W // self.num_heads
        q_in, kv_in = self.ln_1(text), self.ln_1_kv(image)
        wq, wk, wv = self.attn.in_proj_weight.chunk(3, dim=0)
        bq, bk, bv = self.attn.in_proj_bias.chunk(3)
        to_heads = lambda t: t.reshape(B, t.shape[1], self.num_heads, hd).transpose(1, 2)
        q = to_heads(_promoted_matmul(q_in, wq.t()) + bq)
        k = to_heads(_promoted_matmul(kv_in, wk.t()) + bk)
        v = to_heads(_promoted_matmul(kv_in, wv.t()) + bv)
        o = sdpa(q, k, v).transpose(1, 2).reshape(B, L, W)
        o = _linear(o, self.attn.out_proj, compute_dtype)
        if self.ls_1 is not None:
            o = self.ls_1(o)
        text = text + o
        h = gelu_exact(_linear(self.ln_2(text), self.mlp.c_fc, compute_dtype))
        h = _linear(h, self.mlp.c_proj, compute_dtype)
        if self.ls_2 is not None:
            h = self.ls_2(h)
        return text + h


class MultimodalTransformer(nn.Module):
    """The cross-attention text decoder (``multimodal_transformer_forward``):
    a layer is one causal self-attention text block (the text tower's
    ``ResidualAttentionBlock``, given the causal mask as a bias) then one
    cross-attention block into the image tokens; ``ln_final`` and the bare
    projection apply to every token (the full sequence comes back)."""

    def __init__(self, width: int, layers: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 output_dim: int = 512, context_length: int = 77, device="cuda"):
        super().__init__()
        self.context_length = context_length
        self.text_cfg = TextConfig(width=width, heads=num_heads, layers=layers,
                                   mlp_ratio=mlp_ratio)
        with torch.device("meta"):
            self.resblocks = nn.ModuleList(ResidualAttentionBlock(self.text_cfg)
                                           for _ in range(layers))
            self.cross_attn = nn.ModuleList(
                MultimodalCrossBlock(width, num_heads, mlp_ratio, device="meta")
                for _ in range(layers))
            self.ln_final = _layer_norm(width)
            self.text_projection = nn.Parameter(torch.empty(width, output_dim))
        self.to_empty(device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> "MultimodalTransformer":
        """``init_multimodal_transformer_params``, the OpenAI scheme a block
        (text_transformer.py:300-321): in_proj N(0, W^-1), out_proj and
        c_proj N(0, W^-1 / (2 layers)), c_fc N(0, (2W)^-1), zero biases;
        the projection N(0, W^-1)."""
        width, layers = self.text_cfg.width, self.text_cfg.layers
        proj_std = width ** -0.5 * (2 * layers) ** -0.5
        _init_norms_and_scales(self)
        for blk in [*self.resblocks, *self.cross_attn]:
            normal_(blk.attn.in_proj_weight, width ** -0.5, generator)
            blk.attn.in_proj_bias.zero_()
            _init_linear(blk.attn.out_proj, proj_std, generator)
            _init_linear(blk.mlp.c_fc, (2 * width) ** -0.5, generator)
            _init_linear(blk.mlp.c_proj, proj_std, generator)
        normal_(self.text_projection, width ** -0.5, generator)
        return self

    @torch.no_grad()
    def load_jax(self, params: Mapping) -> "MultimodalTransformer":
        for i, (res, cross) in enumerate(zip(self.resblocks, self.cross_attn)):
            p = _layer(params["resblocks"], i)
            _load_norm(res.ln_1, p["ln_1"])
            _load_in_proj(res.attn, p["attn"])
            _load_norm(res.ln_2, p["ln_2"])
            _load_linear(res.mlp.c_fc, p["mlp"]["c_fc"])
            _load_linear(res.mlp.c_proj, p["mlp"]["c_proj"])
            cross.load_jax(_layer(params["cross_attn"], i))
        _load_norm(self.ln_final, params["ln_final"])
        self.text_projection.copy_(_tensor(params["text_projection"]["kernel"],
                                           self.text_projection))
        return self

    def forward(self, image_embs: torch.Tensor, text_embs: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(B, N_img, W) image and (B, L, W) text tokens -> (B, L, output_dim)."""
        L = text_embs.shape[1]
        mask = causal_mask(self.context_length, text_embs.device)[:L, :L]
        x = text_embs
        for res, cross in zip(self.resblocks, self.cross_attn):
            x = res(x, mask, False, compute_dtype)
            x = cross(x, image_embs, compute_dtype)
        return linear(self.ln_final(x), self.text_projection.t(), None, compute_dtype)
