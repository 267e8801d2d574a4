"""Latent diffusion transformer, LightningDiT class (port of
``vtp_tpu/dit/model.py``: ``DiTConfig`` :33, ``DIT_PRESETS`` :78,
``init_dit_params`` :94, ``timestep_embedding`` :149, ``_dit_block`` :161,
``dit_forward`` :228).

adaLN-zero conditioning on the timestep and class embeddings, RMSNorm and
SwiGLU blocks, 2-D RoPE and qk-RMSNorm in the attention. With a head dim
of 64 each block's attention is the fused qkv + qk-norm + RoPE kernel
(``ops/flash_attention.py``), whose backward has the qk-norm arm; the
JAX package takes the same kernels on a TPU. Where
``fused_attention_supported`` fails (head dims outside {32, 64, 128},
LightningDiT's 16 heads of 72) the attention takes the split path on
``ops/attention.sdpa``, as the JAX package does, which for those head
dims is ``sdpa_reference``; head dims 32 and 128 go to the fused function,
whose kernel takes 64 and raises on a CUDA tensor.

The RoPE periods are an fp32 buffer (``rope_periods``) with no gradient,
as the fused kernel's VJP gives the tables (the JAX split path on a CPU
differentiates them). ``load_numpy_dit_params`` fills a module from the
JAX parameter tree as numpy arrays, and ``load_numpy_dit_state`` a whole
train state (parameters, EMA, Adam moments and count, step) from the JAX
train state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vtp_tpu_torch.models.blocks import SwiGLUFFN, checkpoint_policy
from vtp_tpu_torch.models.initializers import linear_, normal_
from vtp_tpu_torch.ops.attention import sdpa
from vtp_tpu_torch.ops.ffn import linear, swiglu_hidden_dim
from vtp_tpu_torch.ops.flash_attention import fused_attention_supported, fused_qkv_rope_attention
from vtp_tpu_torch.ops.norms import rms_norm
from vtp_tpu_torch.ops.rope import rope_apply, rope_periods_init, rope_sincos

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """A copy of the JAX package's ``DiTConfig`` (same fields and defaults)."""

    input_size: int = 16           # latent grid (f16d64 at 256px)
    patch_size: int = 1
    in_channels: int = 64
    dim: int = 1152
    depth: int = 28
    num_heads: int = 16
    ffn_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    rope_base: float = 100.0
    use_qk_norm: bool = True
    norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def tokens_per_side(self) -> int:
        return self.input_size // self.patch_size

    @property
    def token_dim(self) -> int:
        return self.in_channels * self.patch_size**2

    @property
    def ffn_hidden(self) -> int:
        return swiglu_hidden_dim(self.dim, self.ffn_ratio, 8)

    @property
    def null_label(self) -> int:
        return self.num_classes  # extra row for classifier-free guidance


# XL takes 18 heads of 64 rather than LightningDiT's 16 of 72: at a fixed
# dim the parameter shapes are the same, and a head dim of 64 runs the
# fused attention kernels. make_dit_config(..., num_heads=16) matches
# LightningDiT exactly.
DIT_PRESETS = {
    "DiT-B/1": dict(dim=768, depth=12, num_heads=12, patch_size=1),
    "DiT-L/1": dict(dim=1024, depth=24, num_heads=16, patch_size=1),
    "DiT-XL/1": dict(dim=1152, depth=28, num_heads=18, patch_size=1),
    "DiT-XL/2": dict(dim=1152, depth=28, num_heads=18, patch_size=2),
}


def make_dit_config(preset: str = "DiT-XL/1", **kw) -> DiTConfig:
    base = dict(DIT_PRESETS[preset])
    base.update(kw)
    return DiTConfig(**base)


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (DiT convention), fp32 ``[cos, sin]``;
    t in [0, 1] is scaled by 1000 to diffusion-step magnitudes."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = (t.float() * 1000.0)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _unit_rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a unit weight (the blocks' and the final layer's) on the
    fp32 residual stream: ``rms_norm(x, ones)`` without the product by 1."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


class DiTAttention(nn.Module):
    """qkv and out-projection, with the (head_dim,) qk-RMSNorm scales."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.dim, 3 * cfg.dim)
        self.proj = nn.Linear(cfg.dim, cfg.dim)
        if cfg.use_qk_norm:
            self.q_scale = nn.Parameter(torch.empty(cfg.head_dim))
            self.k_scale = nn.Parameter(torch.empty(cfg.head_dim))
        else:
            self.q_scale = self.k_scale = None

    def attend(self, qkv: torch.Tensor, rope: Rope,
               compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
        """(B, N, 3D) qkv -> (B, N, D) attention output, before the proj."""
        cfg = self.cfg
        B, N, _ = qkv.shape
        sin, cos = rope if rope is not None else (None, None)
        if fused_attention_supported(qkv.shape, qkv.dtype, cfg.num_heads):
            return fused_qkv_rope_attention(qkv, sin, cos, cfg.num_heads,
                                            q_scale=self.q_scale, k_scale=self.k_scale)
        q, k, v = qkv.reshape(B, N, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
        if cfg.use_qk_norm:
            # eps 1e-5, the fused kernel's
            q, k = rms_norm(q, self.q_scale), rms_norm(k, self.k_scale)
        if rope is not None:
            # in the tables' dtype, cast back (apply_rope_with_prefix, no prefix)
            q = rope_apply(q.to(sin.dtype), sin, cos).to(q.dtype)
            k = rope_apply(k.to(sin.dtype), sin, cos).to(k.dtype)
        if compute_dtype is not None:
            q, k, v = (t.to(compute_dtype) for t in (q, k, v))
        return sdpa(q, k, v).transpose(1, 2).reshape(B, N, cfg.dim)


class DiTBlock(nn.Module):
    """adaLN-zero block: modulated RMSNorm -> attention -> gated residual,
    modulated RMSNorm -> SwiGLU -> gated residual (``_dit_block``)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.attn = DiTAttention(cfg)
        self.mlp = SwiGLUFFN(cfg.dim, cfg.ffn_hidden, bias=True)
        self.ada = nn.Linear(cfg.dim, 6 * cfg.dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, rope: Rope,
                compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
        eps = self.cfg.norm_eps
        ada = linear(F.silu(cond), self.ada.weight, self.ada.bias, compute_dtype).float()
        sh1, sc1, g1, sh2, sc2, g2 = ada.chunk(6, dim=-1)
        h = _modulate(_unit_rms_norm(x, eps), sh1, sc1)
        attn = self.attn
        qkv = linear(h, attn.qkv.weight, attn.qkv.bias, compute_dtype)
        o = attn.attend(qkv, rope, compute_dtype)
        o = linear(o, attn.proj.weight, attn.proj.bias, compute_dtype)
        x = x + g1[:, None, :] * o.float()
        h = _modulate(_unit_rms_norm(x, eps), sh2, sc2)
        o = self.mlp(h, compute_dtype)
        return x + g2[:, None, :] * o.float()


class _TimestepEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(256, dim)
        self.fc2 = nn.Linear(dim, dim)


class _FinalLayer(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.ada = nn.Linear(cfg.dim, 2 * cfg.dim)
        self.proj = nn.Linear(cfg.dim, cfg.token_dim)


class DiT(nn.Module):
    """The DiT: ``forward(x, t, y)`` predicts the velocity field v(x_t, t, y)
    of (B, C, H, W) latents at times t in [0, 1] for labels y
    (``cfg.null_label`` for the unconditional row).

    The constructor allocates the parameters on ``device`` without
    initialising them; use :meth:`init` for random weights or
    :func:`load_numpy_dit_params` for a JAX parameter tree."""

    def __init__(self, config: DiTConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        with torch.device("meta"):
            self.x_embed = nn.Linear(cfg.token_dim, cfg.dim)
            self.t_embed = _TimestepEmbed(cfg.dim)
            self.y_embed = nn.Embedding(cfg.num_classes + 1, cfg.dim)
            self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
            self.final = _FinalLayer(cfg)
            self.register_buffer("rope_periods", torch.empty(cfg.head_dim // 4))
        self.to_empty(device=device)

    @classmethod
    def init(cls, config: DiTConfig, generator: Optional[torch.Generator] = None,
             device="cuda") -> "DiT":
        """``init_dit_params``: linears trunc_normal(0.02) with zero bias,
        the class table normal(0.02), unit qk-norm scales, and adaLN-zero
        (every block's ``ada``, ``final.ada`` and ``final.proj`` zero), so a
        fresh model predicts exactly 0. Draws come from ``generator``, which
        lives on ``device`` (seeded with 0 when not given)."""
        model = cls(config, device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, nn.Linear):
                    linear_(m, generator)
                elif isinstance(m, DiTAttention) and m.q_scale is not None:
                    nn.init.ones_(m.q_scale)
                    nn.init.ones_(m.k_scale)
            normal_(model.y_embed.weight, 0.02, generator)
            for lin in [b.ada for b in model.blocks] + [model.final.ada, model.final.proj]:
                nn.init.zeros_(lin.weight)
                nn.init.zeros_(lin.bias)
            model.rope_periods.copy_(rope_periods_init(config.head_dim, config.rope_base,
                                                       dtype=torch.float32, device=device))
        return model

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor, *,
                compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                remat: Union[bool, str] = False) -> torch.Tensor:
        """(B, C, H, W) latents, (B,) times, (B,) int labels -> (B, C, H, W)
        fp32 velocity. ``remat`` is the blocks' gradient-checkpoint policy
        (``models/blocks.checkpoint_policy``)."""
        cfg = self.config
        B, C, H, W = x.shape
        ps = cfg.patch_size
        gh, gw = H // ps, W // ps
        tok = x.reshape(B, C, gh, ps, gw, ps).permute(0, 2, 4, 1, 3, 5).reshape(B, gh * gw, -1)
        h = linear(tok, self.x_embed.weight, self.x_embed.bias, compute_dtype).float()

        te = self.t_embed
        t_emb = linear(timestep_embedding(t), te.fc1.weight, te.fc1.bias, compute_dtype)
        t_emb = linear(F.silu(t_emb), te.fc2.weight, te.fc2.bias, compute_dtype)
        cond = t_emb.float() + F.embedding(y, self.y_embed.weight)

        rope = rope_sincos(self.rope_periods, gh, gw)
        run = checkpoint_policy(remat)
        for blk in self.blocks:
            if run is not None and torch.is_grad_enabled():
                h = run(blk, h, cond, rope, compute_dtype)
            else:
                h = blk(h, cond, rope, compute_dtype)

        fin = self.final
        ada = linear(F.silu(cond), fin.ada.weight, fin.ada.bias, compute_dtype).float()
        shift, scale = ada.chunk(2, dim=-1)
        h = _modulate(_unit_rms_norm(h, cfg.norm_eps), shift, scale)
        out = linear(h, fin.proj.weight, fin.proj.bias, compute_dtype)
        out = out.reshape(B, gh, gw, C, ps, ps).permute(0, 3, 1, 4, 2, 5)
        return out.reshape(B, C, H, W).float()


def init_dit_params(cfg: DiTConfig, generator: Optional[torch.Generator] = None,
                    device="cuda") -> DiT:
    """The JAX package's name for :meth:`DiT.init`: a DiT with random weights."""
    return DiT.init(cfg, generator, device)


def dit_forward(model: DiT, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor, *,
                compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                remat: Union[bool, str] = False) -> torch.Tensor:
    """The JAX package's name for :meth:`DiT.forward`."""
    return model(x, t, y, compute_dtype=compute_dtype, remat=remat)


@torch.no_grad()
def load_numpy_dit_params(model: DiT, params: dict) -> None:
    """Fill ``model`` from the JAX parameter tree (``init_dit_params``'s
    layout) as numpy arrays: ``{"kernel": (in, out), "bias"}`` linears
    (transposed to ``nn.Linear``'s (out, in)), or their int8 ``{"q", "scale",
    "bias"}`` into a model that ``quantize_matmul_params`` quantized the same
    way (``tools/sample_dit.py --int8``), the depth-stacked ``blocks``
    leaves split per layer, ``y_embed``, ``rope.periods`` and the qk-norm
    ``scale`` vectors. A shape mismatch or an unfilled tensor raises."""
    own = model.state_dict()
    filled = set()

    def put(name: str, value, dtype=np.float32) -> None:
        value = np.asarray(value, dtype)
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: parameter shape {value.shape} != model shape "
                             f"{tuple(own[name].shape)}")
        own[name].copy_(torch.tensor(value))
        filled.add(name)

    def lin(name: str, p: dict) -> None:
        if "q" in p:  # int8 (quantize_matmul_params): the codes go across as int8
            put(f"{name}.weight.q", np.asarray(p["q"]).T, np.int8)
            put(f"{name}.weight.scale", p["scale"])
        else:
            put(f"{name}.weight", np.asarray(p["kernel"]).T)
        put(f"{name}.bias", p["bias"])

    lin("x_embed", params["x_embed"])
    lin("t_embed.fc1", params["t_embed"]["fc1"])
    lin("t_embed.fc2", params["t_embed"]["fc2"])
    put("y_embed.weight", params["y_embed"])
    put("rope_periods", params["rope"]["periods"])
    blocks = params["blocks"]
    for i in range(len(model.blocks)):
        at = lambda p: {k: np.asarray(v)[i] for k, v in p.items()}
        pre = f"blocks.{i}"
        lin(f"{pre}.attn.qkv", at(blocks["attn"]["qkv"]))
        lin(f"{pre}.attn.proj", at(blocks["attn"]["proj"]))
        if model.config.use_qk_norm:
            put(f"{pre}.attn.q_scale", np.asarray(blocks["attn"]["q_norm"]["scale"])[i])
            put(f"{pre}.attn.k_scale", np.asarray(blocks["attn"]["k_norm"]["scale"])[i])
        for w in ("w1", "w2", "w3"):
            lin(f"{pre}.mlp.{w}", at(blocks["mlp"][w]))
        lin(f"{pre}.ada", at(blocks["ada"]))
    lin("final.ada", params["final"]["ada"])
    lin("final.proj", params["final"]["proj"])
    missing = sorted(set(own) - filled)
    if missing:
        raise KeyError(f"not in the parameter tree: {missing}")


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside a nested optax state."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


@torch.no_grad()
def load_numpy_dit_state(state, jstate: dict) -> None:
    """Fill a ``dit.train.DiTState`` from the JAX package's DiT train state
    (``init_dit_state``'s tree: params, ema, opt_state, step) as numpy
    arrays: the parameters and the EMA through ``load_numpy_dit_params``,
    the Adam moments (fp32 or bf16, cast to the optimizer's moment dtype)
    by the same names, the Adam count and the step."""
    load_numpy_dit_params(state.model, jstate["params"])
    load_numpy_dit_params(state.ema, jstate["ema"])
    adam = _adam_state(jstate["opt_state"])
    if adam is None:
        raise KeyError("no Adam state (count, mu, nu) in opt_state")
    opt = state.optimizer
    scratch = DiT(state.model.config, device="cpu")  # names the JAX moment trees
    for moment in ("mu", "nu"):
        load_numpy_dit_params(scratch, getattr(adam, moment))
        named = scratch.state_dict()
        for name, t in getattr(opt, moment).items():
            t.copy_(named[name])
    opt.count = int(np.asarray(adam.count))
    state.step = int(np.asarray(jstate["step"]))
