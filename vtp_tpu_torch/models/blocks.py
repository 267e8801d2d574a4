"""DINOv3-style pre-norm transformer blocks (port of
``vtp_tpu/models/blocks.py``: ``pack``/``unpack`` :133, ``attention_apply``
:153, ``block_apply_flat`` :394, ``scan_blocks`` :547, ``remat_wrap`` :502).

Parameter names follow the reference checkpoints (``norm1``,
``attn.qkv``, ``attn.proj``, ``mlp.w1``..., ``ls1.gamma``), so a
released state dict loads by name. The depth loop is a plain loop over
an ``nn.ModuleList``. Multi-crop lists are packed once into one
``(sum B_i*N_i, D)`` matrix for every norm and GEMM; attention runs one
fused launch per crop. ``remat`` selects a gradient-checkpoint policy
per block (``checkpoint_policy``, the JAX package's ``remat_wrap``).

Drop-path (``drop_keep_count`` :426, ``sample_drop_indices`` :436,
``_residual_scatter`` :440, ``_block_apply_droppath`` :445) keeps the
crops unpacked (B_i, N_i, D): each block runs its attention branch on a
random batch subset of each crop and its FFN branch on a fresh subset,
and adds each branch's output, scaled by b / keep, at the kept rows. The
subsets are drawn before the depth loop and passed in, so a block that
``torch.utils.checkpoint`` recomputes sees the same rows (it restores the
default RNG states, never an explicit generator's).
``precision`` ("float32" or "high") is the fp32 GEMM and attention mode,
an explicit argument where the JAX package reads the ambient matmul
precision (``vtp_tpu/models/blocks.py:216-227``).

A crop that ``fused_attention_supported`` refuses (the JAX gate's
device-independent conditions, :206-214) takes the split path of
``attention_apply`` (:233-266), as the JAX package does: a head dim outside
{32, 64, 128}, a one-token crop, or a trunk whose qkv columns are in the
head-major layout (``qkv_head_major > 1``, ``parallel/sharding.py``). The
columns are regrouped per head, then qk-norm, RoPE (``apply_rope_bnhd`` :280),
the compute-dtype cast and ``sdpa_bnhd`` (:292), whose bf16 case runs
``flash_attention_bnhd``.

Context parallelism (a tower's ``ContextParallel``, ``parallel.sharding``):
``run_blocks`` pads each (B, N, D) crop with zero tokens to a multiple of
the seq axis S (``n_valid`` masks them as keys; they are sliced off after
the stack) and splits its tokens over the axis (``split_seq`` on dim 1,
each rank's slice of the RoPE tables with them), so each rank holds N/S
tokens of every crop through the blocks. Every attention of such a block
takes the split path (the fused gate refuses it, as the JAX gate does under
a seq axis, :111) and ``sdpa_bnhd`` takes a CP arm in the JAX package's
order (:295-324): Ulysses when the mode is "auto" or "ulysses" and the
rank's heads divide the axis, the ring when the mode is not "ulysses"
(``ops/ring_attention.py``), else the rank's queries against the gathered
keys and values. Pipeline parallelism (a ``PipelineParallel``): the
no-drop-path depth loop runs ``parallel.pipeline.maybe_pipeline_blocks``,
and the sequential loop where that refuses the layout (:591-611).

Under tensor parallelism (``parallel.sharding.parallelize_model``) an
``Attention``, ``SwiGLUFFN`` or ``Mlp`` holds its rank's slabs and a
``tp``; it enters its column-parallel GEMM through ``tp_enter`` and leaves
its row-parallel GEMM through ``tp_exit``, adding the replicated bias after
the reduction. ``run_blocks`` splits the packed rows over the model group
for the depth loop when the model runs sequence-parallel and drop-path is
off (the JAX package pins the drop-path subsets to the data-only layout).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from vtp_tpu_torch.models.initializers import linear_
from vtp_tpu_torch.ops.activations import ACT
from vtp_tpu_torch.ops.ffn import ffn_align_to, linear, mlp, swiglu, swiglu_hidden_dim
from vtp_tpu_torch.ops.attention import sdpa_reference
from vtp_tpu_torch.ops.flash_attention import (
    FUSED_FORWARD_OP,
    flash_attention_bnhd,
    flash_supported_bnhd,
    fused_attention_supported,
    fused_qkv_rope_attention,
)
from vtp_tpu_torch.ops.norms import apply_norm, norm_eps, rms_norm
from vtp_tpu_torch.ops.ring_attention import (
    gathered_attention_local,
    ring_attention_local,
    ring_supported,
    ulysses_attention_local,
    ulysses_supported,
)
from vtp_tpu_torch.ops.rope import rope_apply
from vtp_tpu_torch.parallel.pipeline import maybe_pipeline_blocks
from vtp_tpu_torch.parallel.sharding import (
    ContextParallel,
    PipelineParallel,
    copy_to_model,
    sp_param,
    split_seq,
    tp_enter,
    tp_exit,
    unsplit_seq,
)

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]
Shapes = List[Tuple[int, int]]


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
    # the head-major TP factor the qkv columns are permuted for
    # (parallel/sharding.py; 1 = canonical [Q|K|V])
    qkv_head_major: int = 1

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def ffn_hidden(self) -> int:
        if self.ffn_layer == "mlp":
            return int(self.dim * self.ffn_ratio)
        return swiglu_hidden_dim(self.dim, self.ffn_ratio, ffn_align_to(self.ffn_layer))


class Norm(nn.Module):
    """RMSNorm (weight only) or LayerNorm (weight and bias), fp32 stats;
    ``eps`` defaults to the registry's for ``kind``."""

    def __init__(self, dim: int, kind: str, eps: Optional[float] = None):
        super().__init__()
        self.kind, self.eps = kind, norm_eps(kind) if eps is None else eps
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
    (attention_apply). Each crop takes the fused function where
    ``fused_attention_supported`` holds, as the JAX package does (head dim
    32, 64 or 128, N >= 2, canonical columns), and the split path
    otherwise: head-major columns, a head dim such as 72, a one-token crop.
    Head dims 32 and 128 pass the gate, and on a CUDA tensor the fused
    kernel, which takes 64 alone, raises for them."""

    tp = None  # the TensorParallel of a parallelized model

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
            # LinearKMaskedBias: the K columns of the bias are zeroed every
            # forward; under the head-major layout they sit in each rank group
            hm = self.cfg.qkv_head_major
            keep = torch.ones((hm, 3, self.cfg.dim // hm), dtype=bias.dtype, device=bias.device)
            keep[:, 1] = 0
            bias = bias * keep.reshape(-1)
        return bias

    def split_attention(self, qkv: torch.Tensor, rope: Rope, n_valid: int,
                        compute_dtype: Optional[torch.dtype], precision: str,
                        cp: Optional[ContextParallel] = None) -> torch.Tensor:
        """(b, n, 3D) qkv, canonical or head-major -> (b, n, D): the split
        path of ``attention_apply`` (:233-266); under ``cp``, n is this
        rank's tokens and ``n_valid`` a global count."""
        cfg = self.cfg
        b, n, _ = qkv.shape
        dg = cfg.dim // cfg.qkv_head_major
        grp = qkv.reshape(b, n, cfg.qkv_head_major, 3 * dg)
        q, k, v = (grp[..., i * dg:(i + 1) * dg].reshape(b, n, cfg.num_heads, cfg.head_dim)
                   for i in range(3))
        if cfg.use_qk_norm:
            q, k = rms_norm(q, self.q_norm.weight), rms_norm(k, self.k_norm.weight)
        if rope is not None:
            q, k = apply_rope_bnhd(q, k, *rope)
        if compute_dtype is not None:
            q, k, v = (t.to(compute_dtype) for t in (q, k, v))
        return sdpa_bnhd(q, k, v, n_valid, precision, cp).reshape(b, n, cfg.dim)

    def forward(self, flat: torch.Tensor, shapes: Shapes, ropes: Sequence[Rope],
                n_valids: Sequence[int], compute_dtype: Optional[torch.dtype] = None,
                precision: str = "float32", sp: bool = False,
                cp: Optional[ContextParallel] = None) -> torch.Tensor:
        """flat: the packed (sum B_i*N_i, D) normed tokens of the crops
        whose (B_i, N_i) are ``shapes`` (under ``sp``, this rank's rows of
        them; under ``cp``, N_i is this rank's share of the crop's tokens);
        one qkv GEMM, one fused attention per crop (the split path under
        ``cp``), one out-projection."""
        cfg = self.cfg
        flat = tp_enter(flat, self.tp, sp)
        qkv_flat = linear(flat, self.qkv.weight, self.qkv_bias(), compute_dtype, precision)
        outs, off = [], 0
        for (b, n), rope, n_valid in zip(shapes, ropes, n_valids):
            qkv = qkv_flat[off:off + b * n].reshape(b, n, 3 * cfg.dim)
            off += b * n
            if not fused_attention_supported(qkv.shape, qkv.dtype, cfg.num_heads,
                                             cfg.qkv_head_major,
                                             context_parallel=cp is not None):
                o = self.split_attention(qkv, rope, n_valid, compute_dtype, precision, cp)
                outs.append(o.reshape(b * n, cfg.dim))
                continue
            o = fused_qkv_rope_attention(
                qkv,
                rope[0] if rope is not None else None,
                rope[1] if rope is not None else None,
                cfg.num_heads,
                q_scale=self.q_norm.weight if cfg.use_qk_norm else None,
                k_scale=self.k_norm.weight if cfg.use_qk_norm else None,
                n_valid=n_valid,
                fp32_precision=precision,
            )
            outs.append(o.reshape(b * n, cfg.dim))
        o = outs[0] if len(outs) == 1 else torch.cat(outs)
        return _row_parallel(o, self.proj, self.tp, sp, compute_dtype, precision)


def _row_parallel(x: torch.Tensor, lin: nn.Linear, tp, sp: bool,
                  compute_dtype: Optional[torch.dtype], precision: str) -> torch.Tensor:
    """A row-parallel linear: the local product reduced over the model group
    (``tp_exit``), then the replicated bias; ``linear`` without a ``tp``."""
    if tp is None:
        return linear(x, lin.weight, lin.bias, compute_dtype, precision)
    y = tp_exit(linear(x, lin.weight, None, compute_dtype, precision), tp, sp)
    bias = sp_param(lin.bias, tp, sp)
    return y if bias is None else y + bias.to(y.dtype)


def apply_rope_bnhd(q: torch.Tensor, k: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """RoPE on (B, N, H, hd) with full-length (N, hd) tables, in the tables'
    dtype, cast back (``apply_rope_bnhd`` :280)."""
    s, c = sin[None, :, None, :], cos[None, :, None, :]
    return (rope_apply(q.to(sin.dtype), s, c).to(q.dtype),
            rope_apply(k.to(sin.dtype), s, c).to(k.dtype))


def sdpa_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int = 0,
              precision: str = "float32", cp: Optional[ContextParallel] = None
              ) -> torch.Tensor:
    """Attention over (B, N, H, hd) -> (B, N, H, hd) (``sdpa_bnhd`` :292).
    Under ``cp`` (q, k, v this rank's N/S tokens, ``n_valid`` a global
    count): Ulysses or the ring by ``cp.mode`` and their gates, else the
    gathered keys and values. Otherwise ``flash_attention_bnhd`` for bf16
    with every key valid when ``flash_supported_bnhd`` holds, else the
    written-out math with key columns ``>= n_valid`` masked."""
    if cp is not None:
        if cp.mode in ("auto", "ulysses") and ulysses_supported(q, cp.axis, n_valid):
            return ulysses_attention_local(q, k, v, cp.axis, n_valid=n_valid)
        if cp.mode != "ulysses" and ring_supported(q, cp.axis, n_valid):
            return ring_attention_local(q, k, v, cp.axis, n_valid=n_valid)
        return gathered_attention_local(q, k, v, cp.axis, n_valid, precision)
    if n_valid in (0, q.shape[1]) and flash_supported_bnhd(q, k, v):
        return flash_attention_bnhd(q, k, v)
    o = sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       n_valid=n_valid, precision=precision)
    return o.transpose(1, 2)


class SwiGLUFFN(nn.Module):
    """``w1``, ``w2``, ``w3``; after ``utils.params.fuse_ffn_params``, ``w12``
    (``[w1; w2]``) and ``w3``, with ``w1`` and ``w2`` None."""

    tp = None  # the TensorParallel of a parallelized model

    def __init__(self, dim: int, hidden: int, bias: bool):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden, bias=bias)
        self.w2 = nn.Linear(dim, hidden, bias=bias)
        self.w3 = nn.Linear(hidden, dim, bias=bias)
        self.w12 = None

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                precision: str = "float32", sp: bool = False) -> torch.Tensor:
        if self.tp is None:
            return swiglu(x, self.w1, self.w2, self.w3, compute_dtype, precision, self.w12)
        x = tp_enter(x, self.tp, sp)
        if self.w12 is not None:
            # a fused w12 stays whole: the whole product, then this rank's
            # columns of each half (its gradient sums over the model group)
            axis = self.tp.axis
            w12 = self.w12
            bias = None if w12.bias is None else copy_to_model(w12.bias, axis)
            x1, x2 = (t.chunk(axis.size, dim=-1)[axis.rank] for t in linear(
                x, copy_to_model(w12.weight, axis), bias, compute_dtype,
                precision).chunk(2, dim=-1))
        else:
            x1 = linear(x, self.w1.weight, self.w1.bias, compute_dtype, precision)
            x2 = linear(x, self.w2.weight, self.w2.bias, compute_dtype, precision)
        return _row_parallel(F.silu(x1) * x2, self.w3, self.tp, sp, compute_dtype, precision)


class Mlp(nn.Module):
    tp = None  # the TensorParallel of a parallelized model

    def __init__(self, dim: int, hidden: int, bias: bool, act: str):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(dim, hidden, bias=bias)
        self.fc2 = nn.Linear(hidden, dim, bias=bias)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                precision: str = "float32", sp: bool = False) -> torch.Tensor:
        if self.tp is None:
            return mlp(x, self.fc1, self.fc2, ACT[self.act], compute_dtype, precision)
        x = tp_enter(x, self.tp, sp)
        h = ACT[self.act](linear(x, self.fc1.weight, self.fc1.bias, compute_dtype, precision))
        return _row_parallel(h, self.fc2, self.tp, sp, compute_dtype, precision)


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
                compute_dtype: Optional[torch.dtype] = None, precision: str = "float32"
                ) -> torch.Tensor:
        """One (B, N, D) crop (block_apply)."""
        B, N, D = x.shape
        out = self.forward_packed(x.reshape(B * N, D), [(B, N)], [rope], [n_valid or N],
                                  compute_dtype, precision)
        return out.reshape(B, N, D)

    def forward_packed(self, flat: torch.Tensor, shapes: Shapes, ropes: Sequence[Rope],
                       n_valids: Sequence[int], compute_dtype: Optional[torch.dtype] = None,
                       precision: str = "float32", sp: bool = False,
                       cp: Optional[ContextParallel] = None) -> torch.Tensor:
        """On the packed tokens of the crops (block_apply_flat); under
        ``sp``, on this rank's rows of them; under ``cp``, on this rank's
        tokens of each crop."""
        tp = self.attn.tp
        a = self.attn(_norm(self.norm1, flat, tp, sp), shapes, ropes, n_valids, compute_dtype,
                      precision, sp, cp)
        flat = flat + _scale(self.ls1, a, tp, sp)
        f = self.mlp(_norm(self.norm2, flat, tp, sp), compute_dtype, precision, sp)
        return flat + _scale(self.ls2, f, tp, sp)

    def forward_droppath(self, xs: Sequence[torch.Tensor], ropes: Sequence[Rope],
                         n_valids: Sequence[int], idx: Sequence[torch.Tensor],
                         compute_dtype: Optional[torch.dtype] = None,
                         precision: str = "float32",
                         scales: Optional[Sequence[float]] = None,
                         cp: Optional[ContextParallel] = None) -> List[torch.Tensor]:
        """Drop-path on (B_i, N_i, D) crops (``_block_apply_droppath``):
        ``idx`` holds the attention branch's kept rows of each crop, then the
        FFN branch's; ``scales`` (same order) their residual scales when they
        are a data shard's part of a global subset; under ``cp`` the crops
        hold this rank's tokens."""
        n = len(xs)

        def attn(flat, shapes, kept):
            a = self.attn(self.norm1(flat), shapes, [ropes[i] for i in kept],
                          [n_valids[i] for i in kept], compute_dtype, precision, cp=cp)
            return self.ls1(a) if self.ls1 is not None else a

        def ffn(flat, shapes, kept):
            f = self.mlp(self.norm2(flat), compute_dtype, precision)
            return self.ls2(f) if self.ls2 is not None else f

        xs = _droppath_branch(xs, idx[:n], attn, None if scales is None else scales[:n])
        return _droppath_branch(xs, idx[n:], ffn, None if scales is None else scales[n:])


def _norm(norm: "Norm", x: torch.Tensor, tp, sp: bool) -> torch.Tensor:
    if not sp:
        return norm(x)
    return apply_norm(x, sp_param(norm.weight, tp, sp), sp_param(norm.bias, tp, sp),
                      norm.kind, norm.eps)


def _scale(ls: Optional["LayerScale"], x: torch.Tensor, tp, sp: bool) -> torch.Tensor:
    return x if ls is None else x * sp_param(ls.gamma, tp, sp)


def _droppath_branch(xs: Sequence[torch.Tensor], idx: Sequence[torch.Tensor],
                     fn: Callable[[torch.Tensor, Shapes, List[int]], torch.Tensor],
                     scales: Optional[Sequence[float]] = None) -> List[torch.Tensor]:
    """``fn`` on the packed kept rows of every crop (its arguments: them, their
    shapes, the indices of the crops they come from), each crop's output added
    back at its rows, scaled by b / keep (or by ``scales``, the global batch's
    b / keep, when ``idx`` are this data shard's part of a global subset; a
    crop with no kept row here is left as it is)."""
    if scales is None:
        scales = [x.shape[0] / max(ix.numel(), 1) for x, ix in zip(xs, idx)]
    kept = [i for i, ix in enumerate(idx) if ix.numel() > 0]
    if not kept:
        return list(xs)
    sub = [xs[i][idx[i]] for i in kept]
    shapes = [(t.shape[0], t.shape[1]) for t in sub]
    d = xs[0].shape[-1]
    out = fn(torch.cat([t.reshape(-1, d) for t in sub]), shapes, kept)
    res, off = list(xs), 0
    for i, (b, n) in zip(kept, shapes):
        r = out[off:off + b * n].reshape(b, n, d)
        off += b * n
        res[i] = _residual_scatter(xs[i], r, idx[i], scales[i])
    return res


def drop_keep_count(batch: int, drop_ratio: float, shards: int = 1) -> int:
    """Rows a crop keeps in a drop-path branch: the reference's global keep
    (block.py:55-66) split equally over ``shards``, rounded down."""
    if shards <= 1:
        return max(int(batch * (1.0 - drop_ratio)), 1)
    global_keep = max(int(batch * shards * (1.0 - drop_ratio)), shards)
    return min(max(global_keep // shards, 1), batch)


def sample_drop_indices(generator: torch.Generator, batch: int, keep: int) -> torch.Tensor:
    return torch.randperm(batch, generator=generator, device=generator.device)[:keep]


def draw_drop_indices(generator: torch.Generator, batches: Sequence[int], depth: int,
                      drop_ratio: float, shards: int = 1) -> List[List[torch.Tensor]]:
    """Every block's kept rows for crops of ``batches`` rows: per block, the
    attention branch's subset of each crop, then the FFN branch's (the
    order of JAX's ``split(key, 2 * len(xs))``); ``shards`` is
    ``drop_keep_count``'s (the JAX step draws over the global batch)."""
    return [[sample_drop_indices(generator, b, drop_keep_count(b, drop_ratio, shards))
             for b in list(batches) * 2] for _ in range(depth)]


def _residual_scatter(x: torch.Tensor, res: torch.Tensor, idx: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """x with ``scale * res`` (in fp32, cast to x's dtype) added at rows ``idx``."""
    return x.index_add(0, idx, (scale * res.float()).to(x.dtype))


# The ops whose outputs each selective policy saves: 2-D matmuls
# (dots_with_no_batch_dims_saveable), the fused attention forward (the
# output tagged "attn_out" in the JAX package), or both.
_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)
_ATTN = (FUSED_FORWARD_OP,)
SELECTIVE_POLICIES = {"dots": _DOTS, "attn": _ATTN, "dots_attn": _DOTS + _ATTN}


def _save_policy(saved, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op.overloadpacket in saved:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_policy(remat: Union[bool, str, None]) -> Optional[Callable[..., torch.Tensor]]:
    """The JAX package's ``remat_wrap`` (``vtp_tpu/models/blocks.py:502``):
    None for False/None (save everything), else ``run(fn, *args)``, which
    calls ``fn`` under ``torch.utils.checkpoint`` with the policy:

      True / "full"  save nothing; the backward recomputes the whole block;
      "dots"         save the outputs of 2-D matmuls (``aten.mm``,
                     ``aten.addmm``) and recompute the rest, the fused
                     attention forward included;
      "attn"         save the fused attention forward's output
                     (``ops.flash_attention.FUSED_FORWARD_OP``): the backward
                     recomputes the GEMMs and elementwise ops but never
                     launches the fused forward again;
      "dots_attn"    both.

    Any other value raises ``ValueError``. Every policy computes what
    ``remat=False`` does, bit for bit where the recompute is deterministic;
    only what is kept between the forward and the backward changes. A
    block that takes the split attention path (head-major columns, a head
    dim off the fused gate) has no fused forward to save and recomputes its
    attention under "attn"."""
    if remat is False or remat is None:
        return None
    if remat is True or remat == "full":
        return functools.partial(checkpoint, use_reentrant=False)
    if not isinstance(remat, str) or remat not in SELECTIVE_POLICIES:
        raise ValueError(f"unknown remat mode: {remat!r}")
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   functools.partial(_save_policy, SELECTIVE_POLICIES[remat]))
    return functools.partial(checkpoint, use_reentrant=False, context_fn=context_fn)


def run_blocks(blocks: nn.ModuleList, xs: Sequence[torch.Tensor], ropes: Sequence[Rope],
               n_valids: Optional[Sequence[int]] = None,
               compute_dtype: Optional[torch.dtype] = None,
               remat: Union[bool, str] = False, precision: str = "float32",
               drop: Optional[Sequence[Sequence[torch.Tensor]]] = None,
               drop_scales: Optional[Sequence[Sequence[float]]] = None,
               cp: Optional[ContextParallel] = None, pp: Optional[PipelineParallel] = None
               ) -> List[torch.Tensor]:
    """The depth loop over a list of (B_i, N_i, D) crops (scan_blocks):
    packed once, unpacked at the end. ``n_valids`` masks trailing key
    columns per crop (default: all valid). ``drop`` (per block, the kept
    rows of ``draw_drop_indices``) runs every block with drop-path on
    unpacked crops, with ``drop_scales`` (per block) as the residual scales
    when given. A sequence-parallel model splits the packed rows over its
    model group for the loop. Under ``cp`` each crop's tokens, padded to a
    multiple of the seq axis, are split over it for the loop; under ``pp``
    the no-drop-path loop is pipelined where ``pp_supported`` holds."""
    n_valids = list(n_valids) if n_valids is not None else [x.shape[1] for x in xs]
    ropes = list(ropes)
    run = checkpoint_policy(remat) if torch.is_grad_enabled() else None
    if cp is not None:
        lengths = [x.shape[1] for x in xs]
        xs, ropes = _split_tokens(xs, ropes, cp)
        xs = _run_stack(blocks, xs, ropes, n_valids, compute_dtype, run, precision, drop,
                        drop_scales, cp)
        return [unsplit_seq(x, cp.axis, 1)[:, :n] for x, n in zip(xs, lengths)]
    if drop is None and pp is not None:
        out = maybe_pipeline_blocks(xs, blocks, ropes, pp.axis, n_valids=n_valids,
                                    compute_dtype=compute_dtype, remat=remat,
                                    precision=precision)
        if out is not None:
            return out
    return _run_stack(blocks, xs, ropes, n_valids, compute_dtype, run, precision, drop,
                      drop_scales, None)


def _split_tokens(xs: Sequence[torch.Tensor], ropes: Sequence[Rope], cp: ContextParallel
                  ) -> Tuple[List[torch.Tensor], List[Rope]]:
    """Each (B, N, D) crop padded with zero tokens to a multiple of the seq
    axis and this rank's slice of its tokens (``split_seq``: the backward
    gathers the gradient), with the matching rows of its RoPE tables (the
    padded rows 0, as ``vit._pad_tokens`` pads them)."""
    g = cp.axis
    out_x, out_r = [], []
    for x, rope in zip(xs, ropes):
        pad = (-x.shape[1]) % g.size
        out_x.append(split_seq(F.pad(x, (0, 0, 0, pad)), g, 1))
        out_r.append(None if rope is None else
                     tuple(split_seq(F.pad(t, (0, 0, 0, pad)), g, 0) for t in rope))
    return out_x, out_r


def _run_stack(blocks, xs, ropes, n_valids, compute_dtype, run, precision, drop, drop_scales,
               cp) -> List[torch.Tensor]:
    """``run_blocks``' sequential depth loop (the drop-path loop on unpacked
    crops, else the packed loop with sequence parallelism where it holds)."""
    if drop is not None:
        xs = list(xs)
        scales = drop_scales if drop_scales is not None else [None] * len(drop)
        for blk, idx, sc in zip(blocks, drop, scales, strict=True):
            if run is not None:
                xs = run(blk.forward_droppath, xs, ropes, n_valids, list(idx), compute_dtype,
                         precision, sc, cp)
            else:
                xs = blk.forward_droppath(xs, ropes, n_valids, list(idx), compute_dtype,
                                          precision, sc, cp)
        return xs
    shapes = [(x.shape[0], x.shape[1]) for x in xs]
    flat = pack(xs)
    tp = blocks[0].attn.tp if len(blocks) else None
    sp = tp is not None and tp.seq_split(flat.shape[0])
    if sp:
        flat = split_seq(flat, tp.axis)
    for blk in blocks:
        if run is not None:
            flat = run(blk.forward_packed, flat, shapes, ropes, n_valids, compute_dtype,
                       precision, sp, cp)
        else:
            flat = blk.forward_packed(flat, shapes, ropes, n_valids, compute_dtype, precision,
                                      sp, cp)
    if sp:
        flat = unsplit_seq(flat, tp.axis)
    return unpack(flat, [x.shape for x in xs])


def pack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """(..., D) tensors -> one (sum of their rows, D) matrix (``pack`` :133)."""
    d = xs[0].shape[-1]
    return torch.cat([x.reshape(-1, d) for x in xs]) if len(xs) > 1 else xs[0].reshape(-1, d)


def unpack(flat: torch.Tensor, shapes: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """The inverse of ``pack`` for tensors of ``shapes``."""
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape[:-1])
        out.append(flat[off:off + n].reshape(shape))
        off += n
    return out


def reset_block_parameters(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """The reference init of every block under ``module``: linears
    trunc_normal(0.02) with zero bias, norms ones/zeros, LayerScale at its
    init value."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            linear_(m, generator)
        elif isinstance(m, (Norm, LayerScale)):
            m.reset_parameters()
