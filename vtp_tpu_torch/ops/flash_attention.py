"""Fused qkv-split + qk-RMSNorm + RoPE + attention, and its backward; and
the strided attention without a prologue.

Port of ``vtp_tpu/ops/flash_attention.py``: ``fused_qkv_rope_attention``
(:398), its Pallas kernel ``_fused_kernel_call`` (:423), the custom VJP
``_fused_with_vjp`` (:338) and the backward kernel
``_fused_bwd_kernel_call`` (:641). Their Hopper counterparts are the
hand-written CUDA kernels ``csrc/fused_attention.cu`` and
``csrc/fused_attention_bwd.cu``; ``fused_qkv_rope_attention_reference``
(the counterpart of ``_fused_reference_impl``, :282) and
``fused_qkv_rope_attention_bwd_reference`` are their plain PyTorch
versions.

The wrappers pick by the tensor's device alone (``ops/dispatch.py``): a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises. The forward kernel has three arms: bf16 (the encode and
training), and for fp32 (the decode) by ``fp32_precision`` as the JAX
wrapper (:398-421): exact ("float32") or the bf16x3 split ("high", the
TPU kernel's ``dot_mode="bf16_3x"``, :466-475 and :516-526). A bf16 call
ignores ``fp32_precision``, as the JAX kernel does.

``fused_qkv_rope_attention`` is differentiable through
``torch.autograd.Function``; its backward picks as ``_fused_with_vjp.bwd``
does: bf16 runs the backward kernel, with its qk-norm arm when the call
has qk-norm scales (the DiT training path; the RMSNorm adjoint and the
scales' gradients), and the plain version of the same arm on the CPU;
fp32 recomputes the exact plain forward and takes its autograd, at either
precision ("high" is an inference mode). The RoPE tables
get no gradient: the periods are a buffer, not a parameter. The TPU
package's VMEM gate on the qk-norm arm (``_fused_bwd_qk_norm_fits``) has
no counterpart here.

``flash_attention_bnhd`` (:1024) and ``flash_attention`` (:1081) are
non-causal, unmasked attention on separate q, k, v, in (B, N, H, d) and
(B, H, N, d); their Hopper counterpart is ``csrc/flash_attention.cu``
(one entry each, strided inputs), their plain versions
``flash_attention_bnhd_reference`` and ``flash_attention_reference``.
``fused_attention_supported``, ``flash_supported`` and
``flash_supported_bnhd`` are the JAX gates' dtype, shape, head-dim and
layout conditions, without the TPU's VMEM budget, sequence cap and mesh
checks; the models route with them on either device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from vtp_tpu_torch.ops.attention import sdpa_reference
from vtp_tpu_torch.ops.dispatch import count_launch, on_kernel_device
from vtp_tpu_torch.ops.norms import rms_norm
from vtp_tpu_torch.ops.precision import check_precision, split_bf16
from vtp_tpu_torch.ops.rope import rope_apply

FUSED_HEAD_DIMS = (32, 64, 128)  # head dims the JAX gate and the CUDA kernels take
KERNEL_TILE = 64  # rows of a block of the backward kernel (csrc/attention_common.cuh kTile)
_ENTRY = {torch.bfloat16: "vtp_fused_qkv_rope_attention_bf16",
          torch.float32: "vtp_fused_qkv_rope_attention_f32"}
# launch-count names, one per arm
ARM_NAME = {torch.bfloat16: "fused_qkv_rope_attention_bf16",
            torch.float32: "fused_qkv_rope_attention_fp32"}
# the bf16 arm with qk-norm scales (the DiT path): the same entry, counted apart
NORM_NAME = "fused_qkv_rope_attention_bf16_qk_norm"
HIGH_ENTRY = "vtp_fused_qkv_rope_attention_f32_bf16x3"
HIGH_NAME = "fused_qkv_rope_attention_fp32_bf16x3"
BWD_ENTRY = "vtp_fused_qkv_rope_attention_bwd_bf16"
BWD_NAME = "fused_qkv_rope_attention_bwd_bf16"
NORM_BWD_ENTRY = "vtp_fused_qkv_rope_attention_qk_norm_bwd_bf16"
NORM_BWD_NAME = "fused_qkv_rope_attention_qk_norm_bwd_bf16"
NORM_EPS = 1e-5  # the kernels' qk-RMSNorm epsilon


def _is_high(dtype: torch.dtype, fp32_precision: str) -> bool:
    """Whether a call takes the bf16x3 arm: fp32 input at "high"."""
    return dtype == torch.float32 and fp32_precision == "high"


def _rms_norm_high(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``rms_norm`` whose mean of squares sums the bf16x3 halves of each
    square, as the TPU kernel's statistics dot does at "high"."""
    xf = x.float()
    hi, lo = split_bf16(xf * xf)
    ms = (hi.float() + lo.float()).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + NORM_EPS)).to(x.dtype) * weight


def fused_qkv_rope_attention_reference(
    qkv: torch.Tensor,
    sin: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    num_heads: int,
    q_scale: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    n_valid: int = 0,
    is_causal: bool = False,
    fp32_precision: str = "float32",
) -> torch.Tensor:
    """Plain version: (B, N, 3*H*d) packed [Q|K|V] -> (B, N, H*d). At
    ``fp32_precision="high"`` an fp32 call takes the qk-norm statistics,
    the scores and p·v as the bf16x3 split."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    d = D // num_heads
    high = _is_high(qkv.dtype, fp32_precision)
    q, k, v = qkv.reshape(B, N, 3, num_heads, d).unbind(2)
    if q_scale is not None:
        norm = _rms_norm_high if high else rms_norm
        q = norm(q, q_scale).to(qkv.dtype)
        k = norm(k, k_scale).to(qkv.dtype)
    if sin is not None:
        s = sin[None, :, None, :].to(torch.bfloat16)
        c = cos[None, :, None, :].to(torch.bfloat16)
        q = rope_apply(q.to(torch.bfloat16), s, c).to(qkv.dtype)
        k = rope_apply(k.to(torch.bfloat16), s, c).to(qkv.dtype)
    o = sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       is_causal=is_causal, n_valid=n_valid,
                       precision="high" if high else "float32")
    return o.transpose(1, 2).reshape(B, N, D)


def _check(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid,
           fp32_precision="float32") -> None:
    check_precision(fp32_precision)
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*H*d) with H={num_heads}; got {tuple(qkv.shape)}")
    if qkv.dtype not in _ENTRY:
        raise TypeError(f"qkv dtype must be bfloat16 or float32; got {qkv.dtype}")
    N, d = qkv.shape[1], qkv.shape[-1] // (3 * num_heads)
    if (sin is None) != (cos is None) or (q_scale is None) != (k_scale is None):
        raise ValueError("sin/cos and q_scale/k_scale come in pairs")
    if sin is not None and (tuple(sin.shape) != (N, d) or tuple(cos.shape) != (N, d)):
        raise ValueError(f"rope tables must be ({N}, {d}); got {tuple(sin.shape)}, {tuple(cos.shape)}")
    if q_scale is not None and (tuple(q_scale.shape) != (d,) or tuple(k_scale.shape) != (d,)):
        raise ValueError(f"qk-norm scales must be ({d},)")
    if not 0 <= n_valid <= N:
        raise ValueError(f"n_valid={n_valid} outside [0, {N}]")


def _kernel_fn(entry: str, n_pointers: int = 6):
    """The C entry point: ``n_pointers`` pointers, then seven ints (B, N, H,
    d, n_valid, causal, device) and the stream."""
    from vtp_tpu_torch import _build

    fn = getattr(_build.load_library(), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


def at_head_dim(name: str, d: int) -> str:
    """A launch-count name at head dim d: the arm's own name at 64 and
    ``{name}_d{d}`` at 32 and 128, so that a run shows which instantiation
    of each arm it launched."""
    return name if d == 64 else f"{name}_d{d}"


def arm_name(dtype: torch.dtype, fp32_precision: str = "float32", qk_norm: bool = False,
             d: int = 64) -> str:
    """The launch-count name of the forward arm a call takes at head dim d;
    a bf16 call with qk-norm scales counts under ``NORM_NAME``."""
    if _is_high(dtype, fp32_precision):
        return at_head_dim(HIGH_NAME, d)
    return at_head_dim(NORM_NAME if qk_norm and dtype == torch.bfloat16 else ARM_NAME[dtype], d)


def _launch(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid, is_causal,
            fp32_precision) -> torch.Tensor:
    B, N, three_d = qkv.shape
    D = three_d // 3
    d = D // num_heads
    if d not in FUSED_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {FUSED_HEAD_DIMS}; got {d}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    dev = qkv.device
    extras = [t for t in (sin, cos, q_scale, k_scale) if t is not None]
    if any(t.device != dev for t in extras):
        raise ValueError("all inputs must be on the device of qkv")
    if sin is not None:
        sin = sin.to(torch.bfloat16).contiguous()
        cos = cos.to(torch.bfloat16).contiguous()
    if q_scale is not None:
        q_scale = q_scale.float().contiguous()
        k_scale = k_scale.float().contiguous()
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    high = _is_high(qkv.dtype, fp32_precision)
    rc = _kernel_fn(HIGH_ENTRY if high else _ENTRY[qkv.dtype])(
        ptr(qkv), ptr(sin), ptr(cos), ptr(q_scale), ptr(k_scale), ptr(out),
        B, N, num_heads, d, n_valid or N, int(bool(is_causal)), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused attention kernel launch failed: CUDA error {rc}")
    count_launch(arm_name(qkv.dtype, fp32_precision, q_scale is not None, d))
    return out


def _forward(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid, is_causal,
             fp32_precision="float32") -> torch.Tensor:
    if on_kernel_device(qkv):
        return _launch(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid, is_causal,
                       fp32_precision)
    return fused_qkv_rope_attention_reference(qkv, sin, cos, num_heads, q_scale, k_scale,
                                              n_valid, is_causal, fp32_precision)


# ``_forward`` as one operator of the dispatcher, so that a selective
# checkpoint policy sees the fused forward and can save its output
# (``models/blocks.checkpoint_policy``: "attn", "dots_attn"); the backward's
# recompute then takes the saved output and launches nothing. It has no
# autograd of its own: ``_FusedAttention`` calls it, and only while a
# dispatch mode (such a policy) is active, since the dispatcher's Python
# kernel costs several microseconds a call.
_LIB = torch.library.Library("vtp_torch", "DEF")
_LIB.define("fused_attention_forward(Tensor qkv, Tensor? sin, Tensor? cos, Tensor? q_scale, "
            "Tensor? k_scale, int num_heads, int n_valid, bool is_causal, str fp32_precision) "
            "-> Tensor")


def _forward_op_impl(qkv, sin, cos, q_scale, k_scale, num_heads, n_valid, is_causal,
                     fp32_precision):
    return _forward(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid, is_causal,
                    fp32_precision)


_LIB.impl("fused_attention_forward", _forward_op_impl, "CompositeExplicitAutograd")
FUSED_FORWARD_OP = torch.ops.vtp_torch.fused_attention_forward


def _rope_adjoint(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Transpose of rotate-half RoPE on (..., d) fp32 values with bf16
    tables: dx = x*cos + [(x*sin)[d/2:], -(x*sin)[:d/2]]."""
    z = x * sin
    z1, z2 = z.chunk(2, dim=-1)
    return x * cos + torch.cat([z2, -z1], dim=-1)


def _attention_adjoint(q, k, v, g, sin, cos, n_valid, is_causal):
    """The attention VJP of the bwd kernels on split (B, N, H, d) q, k, v in
    the input dtype, q and k as the forward hands them to the scores
    (normed and scaled, not yet roped). Returns dq and dk after the RoPE
    adjoint, in fp32 (not rounded), and dv in the input dtype, all
    (B, N, H, d)."""
    B, N, H, d = q.shape
    dt = q.dtype
    if sin is not None:
        s = sin[None, :, None, :].to(torch.bfloat16)
        c = cos[None, :, None, :].to(torch.bfloat16)
        q = rope_apply(q.to(torch.bfloat16), s, c).to(dt)
        k = rope_apply(k.to(torch.bfloat16), s, c).to(dt)
    q, k, v = (t.transpose(1, 2).float() for t in (q, k, v))  # (B, H, N, d)
    go = g.reshape(B, N, H, d).transpose(1, 2).float()
    scale = d ** -0.5
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if n_valid and n_valid != N:
        scores = scores.masked_fill(torch.arange(N, device=q.device) >= n_valid, float("-inf"))
    if is_causal:
        keep = torch.ones((N, N), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), go)
    dp = torch.matmul(go, v.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k).to(dt).float()
    dk = torch.matmul(ds.transpose(-1, -2), q).to(dt).float()
    if sin is not None:
        s = sin[None, None].to(torch.bfloat16).float()
        c = cos[None, None].to(torch.bfloat16).float()
        dq, dk = _rope_adjoint(dq, s, c), _rope_adjoint(dk, s, c)
    return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2).to(dt))


def fused_qkv_rope_attention_bwd_reference(
    qkv: torch.Tensor,
    g: torch.Tensor,
    sin: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    num_heads: int,
    n_valid: int = 0,
    is_causal: bool = False,
) -> torch.Tensor:
    """Plain backward without qk-norm: (B, N, 3*H*d) saved qkv and the
    (B, N, H*d) output cotangent -> d(qkv), (B, N, 3*H*d).

    Written out as ``_fused_bwd_kernel_call`` computes it, with its
    rounding points in the input dtype (bf16 on the training path; fp32
    rounds nowhere): p in fp32; dv = bf16(p)ᵀ g; dp = g vᵀ;
    delta = rowsum(p ⊙ dp); ds = bf16(p ⊙ (dp − delta) · d^-½);
    dq̃ = bf16(ds k), dk̃ = bf16(dsᵀ q); then the RoPE adjoint in fp32,
    rounded once. q and k are re-roped as the forward rounds them."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    q, k, v = qkv.reshape(B, N, 3, num_heads, D // num_heads).unbind(2)
    dq, dk, dv = _attention_adjoint(q, k, v, g, sin, cos, n_valid, is_causal)
    return torch.cat([t.reshape(B, N, D).to(qkv.dtype) for t in (dq, dk, dv)], dim=-1)


def _rms_norm_adjoint(dsc: torch.Tensor, x: torch.Tensor, r: torch.Tensor,
                      w: torch.Tensor):
    """Adjoint of y = (x·r)·w with r = rsqrt(mean_h(x²) + eps), in fp32:
    dw = Σ_rows dsc ⊙ (x·r) over (B, N, H); dn = dsc·w;
    dx = r·dn − x·r³·mean_h(dn ⊙ x)."""
    dw = (dsc * (x * r)).sum((0, 1, 2))
    dn = dsc * w
    dx = r * dn - x * (r * r * r) * (dn * x).mean(-1, keepdim=True)
    return dx, dw


def fused_qkv_rope_attention_qk_norm_bwd_reference(
    qkv: torch.Tensor,
    g: torch.Tensor,
    sin: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    num_heads: int,
    n_valid: int = 0,
    is_causal: bool = False,
):
    """Plain backward of the qk-norm arm (the DiT training path): the saved
    qkv, the output cotangent g and the (d,) fp32 scales -> (d(qkv),
    dw_q, dw_k), d(qkv) in the input dtype, dw_q and dw_k fp32 (d,) summed
    over batch, rows and heads.

    Written out as ``_fused_bwd_kernel_call``'s qk-norm arm computes it:
    r = rsqrt(mean_h(x²) + 1e-5); q = bf16(bf16(x·r)·w) as the forward
    rounds it (k alike), roped per op; the attention adjoint of the arm
    without qk-norm, then its RoPE adjoint rounded to the input dtype (dsc);
    dw = Σ_rows dsc ⊙ (x·r); dn = dsc·w; dx = r·dn − x·r³·mean_h(dn ⊙ x)
    in fp32, rounded once. The TPU kernel's block-diagonal mean dot rounds
    its operands to bf16; here, as in the CUDA kernel, the means are fp32."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    d = D // num_heads
    dt = qkv.dtype
    xq, xk, v = qkv.reshape(B, N, 3, num_heads, d).unbind(2)
    xq, xk = xq.float(), xk.float()
    rq = torch.rsqrt((xq * xq).mean(-1, keepdim=True) + NORM_EPS)
    rk = torch.rsqrt((xk * xk).mean(-1, keepdim=True) + NORM_EPS)
    wq, wk = q_scale.float(), k_scale.float()
    q = ((xq * rq).to(dt) * wq).to(dt)
    k = ((xk * rk).to(dt) * wk).to(dt)
    dq, dk, dv = _attention_adjoint(q, k, v, g, sin, cos, n_valid, is_causal)
    dxq, dwq = _rms_norm_adjoint(dq.to(dt).float(), xq, rq, wq)
    dxk, dwk = _rms_norm_adjoint(dk.to(dt).float(), xk, rk, wk)
    d_qkv = torch.cat([t.reshape(B, N, D).to(dt) for t in (dxq, dxk, dv)], dim=-1)
    return d_qkv, dwq, dwk


def _launch_bwd(qkv, g, sin, cos, num_heads, n_valid, is_causal, q_scale=None, k_scale=None):
    """Launch the backward kernel; with qk-norm scales, its qk-norm arm,
    which also returns dw_q and dw_k (the sum of the kernel's per-tile dw
    rows, in a fixed order)."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    d = D // num_heads
    if qkv.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"the backward kernel takes bf16; got qkv {qkv.dtype}, g {g.dtype}")
    if d not in FUSED_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {FUSED_HEAD_DIMS}; got {d}")
    if tuple(g.shape) != (B, N, D):
        raise ValueError(f"g must be {(B, N, D)}; got {tuple(g.shape)}")
    g = g.contiguous()
    for t in (qkv, g):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qkv and g must be contiguous and 16-byte aligned")
    dev = qkv.device
    extras = [t for t in (g, sin, cos, q_scale, k_scale) if t is not None]
    if any(t.device != dev for t in extras):
        raise ValueError("all inputs must be on the device of qkv")
    if sin is not None:
        sin = sin.to(torch.bfloat16).contiguous()
        cos = cos.to(torch.bfloat16).contiguous()
    stats = torch.empty((3, B, num_heads, N), dtype=torch.float32, device=dev)
    d_qkv = torch.empty_like(qkv)
    ptr = lambda t: None if t is None else t.data_ptr()
    tail = (B, N, num_heads, d, n_valid or N, int(bool(is_causal)), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if q_scale is None:
        rc = _kernel_fn(BWD_ENTRY)(ptr(qkv), ptr(g), ptr(sin), ptr(cos), ptr(stats),
                                   ptr(d_qkv), *tail)
        name, out = BWD_NAME, d_qkv
    else:
        q_scale = q_scale.float().contiguous()
        k_scale = k_scale.float().contiguous()
        # one dw row per (q or k, batch row, head, tile of KERNEL_TILE rows)
        dws = torch.empty((2, B, num_heads, -(-N // KERNEL_TILE), d),
                          dtype=torch.float32, device=dev)
        rc = _kernel_fn(NORM_BWD_ENTRY, 9)(ptr(qkv), ptr(g), ptr(sin), ptr(cos), ptr(q_scale),
                                           ptr(k_scale), ptr(stats), ptr(dws), ptr(d_qkv), *tail)
        name = NORM_BWD_NAME
        dw = dws.sum((1, 2, 3))
        out = (d_qkv, dw[0], dw[1])
    if rc != 0:
        raise RuntimeError(f"fused attention backward kernel launch failed: CUDA error {rc}")
    count_launch(at_head_dim(name, d))
    return out


def fused_qkv_rope_attention_bwd(
    qkv: torch.Tensor,
    g: torch.Tensor,
    sin: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    num_heads: int,
    n_valid: int = 0,
    is_causal: bool = False,
) -> torch.Tensor:
    """d(qkv) of ``fused_qkv_rope_attention`` without qk-norm, from the
    saved qkv and the output cotangent g: the backward kernel on a CUDA
    tensor (bf16 only), the plain version on a CPU tensor."""
    _check(qkv, sin, cos, num_heads, None, None, n_valid)
    if on_kernel_device(qkv):
        return _launch_bwd(qkv, g, sin, cos, num_heads, n_valid, is_causal)
    return fused_qkv_rope_attention_bwd_reference(qkv, g, sin, cos, num_heads, n_valid, is_causal)


def fused_qkv_rope_attention_qk_norm_bwd(
    qkv: torch.Tensor,
    g: torch.Tensor,
    sin: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    num_heads: int,
    n_valid: int = 0,
    is_causal: bool = False,
):
    """(d(qkv), dw_q, dw_k) of ``fused_qkv_rope_attention`` with qk-norm:
    the backward kernel's qk-norm arm on a CUDA tensor (bf16 only), its
    plain version on a CPU tensor."""
    _check(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid)
    if on_kernel_device(qkv):
        return _launch_bwd(qkv, g, sin, cos, num_heads, n_valid, is_causal, q_scale, k_scale)
    return fused_qkv_rope_attention_qk_norm_bwd_reference(qkv, g, sin, cos, q_scale, k_scale,
                                                          num_heads, n_valid, is_causal)


class _FusedAttention(torch.autograd.Function):
    """The differentiable fused attention (``_fused_with_vjp``). Its forward
    (``_forward``; through ``FUSED_FORWARD_OP`` under a dispatch mode) and
    bf16 backward (``fused_qkv_rope_attention_bwd``, and
    ``fused_qkv_rope_attention_qk_norm_bwd`` with qk-norm) pick the kernel
    or the plain version by device."""

    @staticmethod
    def forward(ctx, qkv, sin, cos, q_scale, k_scale, num_heads, n_valid, is_causal,
                fp32_precision):
        ctx.save_for_backward(qkv, sin, cos, q_scale, k_scale)
        ctx.args = (num_heads, n_valid, is_causal)
        if _get_current_dispatch_mode() is None:
            return _forward(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid, is_causal,
                            fp32_precision)
        return FUSED_FORWARD_OP(qkv, sin, cos, q_scale, k_scale, num_heads, n_valid, is_causal,
                                fp32_precision)

    @staticmethod
    def backward(ctx, g):
        qkv, sin, cos, q_scale, k_scale = ctx.saved_tensors
        num_heads, n_valid, is_causal = ctx.args
        if qkv.dtype == torch.bfloat16 and q_scale is None:
            d_qkv = fused_qkv_rope_attention_bwd(qkv, g.to(qkv.dtype), sin, cos, num_heads,
                                                 n_valid, is_causal)
            return d_qkv, None, None, None, None, None, None, None, None
        if qkv.dtype == torch.bfloat16:
            d_qkv, d_qs, d_ks = fused_qkv_rope_attention_qk_norm_bwd(
                qkv, g.to(qkv.dtype), sin, cos, q_scale, k_scale, num_heads, n_valid, is_causal)
            return (d_qkv, None, None, d_qs.to(q_scale.dtype), d_ks.to(k_scale.dtype), None, None,
                    None, None)
        # fp32, either precision: autograd of the recomputed exact plain forward
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in (qkv, q_scale, k_scale)]
            out = fused_qkv_rope_attention_reference(leaves[0], sin, cos, num_heads, leaves[1],
                                                     leaves[2], n_valid, is_causal)
            wrt = [t for t in leaves if t is not None]
            grads = list(torch.autograd.grad(out, wrt, g))
        d_qkv = grads.pop(0)
        d_qs, d_ks = (grads[0], grads[1]) if q_scale is not None else (None, None)
        return d_qkv, None, None, d_qs, d_ks, None, None, None, None


def fused_qkv_rope_attention(
    qkv: torch.Tensor,
    sin: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    num_heads: int,
    q_scale: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    n_valid: int = 0,
    is_causal: bool = False,
    fp32_precision: str = "float32",
) -> torch.Tensor:
    """(B, N, 3*H*d) packed [Q|K|V] -> (B, N, H*d), differentiable.

    sin/cos: (N, d) tables with the identity rotation over any prefix,
    or None for no RoPE. q_scale/k_scale: (d,) qk-RMSNorm scales or
    None. n_valid: mask key columns >= n_valid (0 = all valid).
    is_causal: mask key columns > the query row. fp32_precision: the fp32
    dot mode, "float32" (exact) or "high" (bf16x3); bf16 ignores it."""
    _check(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid, fp32_precision)
    return _FusedAttention.apply(qkv, sin, cos, q_scale, k_scale, num_heads, int(n_valid),
                                 bool(is_causal), fp32_precision)


# ------------------------------------------------- plain attention, no prologue
#
# Ports of ``flash_attention_bnhd`` (:1024; ``_flash_bnhd_impl`` :953, Pallas
# call :992) and ``flash_attention`` (:1081; ``_attn_kernel`` :179, Pallas call
# :1114): non-causal, unmasked softmax attention on separate q, k, v. Their
# Hopper counterpart is ``csrc/flash_attention.cu``, one C entry point each,
# which takes every input through its own (batch, token, head) strides.

FLASH_HEAD_DIMS = (32, 64, 128)
FLASH_BNHD_ENTRY = "vtp_flash_attention_bnhd_bf16"
FLASH_BNHD_NAME = "flash_attention_bnhd"
FLASH_ENTRY = "vtp_flash_attention_bhnd_bf16"
FLASH_NAME = "flash_attention"


def _flash_shapes_ok(q, k, v) -> bool:
    return (q.dim() == 4 and tuple(q.shape) == tuple(k.shape) == tuple(v.shape)
            and q.dtype == torch.bfloat16 and q.shape[-1] in FLASH_HEAD_DIMS)


def fused_attention_supported(qkv_shape, dtype: torch.dtype, num_heads: int,
                              head_major: int = 1, *, context_parallel: bool = False) -> bool:
    """Whether ``fused_qkv_rope_attention`` takes a (B, N, 3*H*d) packed
    qkv: the device-independent conditions of the JAX gate
    (``fused_attention_supported``, :212-263): bf16 or fp32, d in FUSED_HEAD_DIMS,
    3*H*d the packed width, 2 <= N, canonical [Q|K|V] columns (not
    head-major), and a block that does not run context-parallel (its
    tokens split over a seq axis; the JAX gate refuses under a seq axis,
    :111). The TPU's VMEM budget, sequence cap and other mesh checks have
    no counterpart. Callers take their split path where it fails. Every d
    that passes has its own instantiation of each arm of the CUDA kernels
    (forward and backward), so a CUDA tensor that passes launches one."""
    if dtype not in _ENTRY or head_major != 1 or context_parallel:
        return False
    _, n, three_d = qkv_shape
    d = three_d // (3 * num_heads)
    return d in FUSED_HEAD_DIMS and 3 * num_heads * d == three_d and n >= 2


def flash_supported(q, k, v, *, is_causal: bool = False) -> bool:
    """Whether ``flash_attention`` takes (B, H, N, d) q, k, v: the dtype,
    shape and head-dim conditions of the JAX gate (:163), without its
    TPU-only sequence cap and mesh checks."""
    return not is_causal and _flash_shapes_ok(q, k, v) and q.shape[2] >= 2


def flash_supported_bnhd(q, k, v) -> bool:
    """Whether ``flash_attention_bnhd`` takes (B, N, H, d) q, k, v: the JAX
    gate's (:935) dtype, shape and head-dim conditions, without its VMEM
    budget, sequence cap and mesh checks."""
    return _flash_shapes_ok(q, k, v) and q.shape[1] >= 2


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of ``flash_attention``: ``sdpa_reference`` on (B, H, N, d)."""
    return sdpa_reference(q, k, v)


def flash_attention_bnhd_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor) -> torch.Tensor:
    """Plain version of ``flash_attention_bnhd``: ``sdpa_reference``'s math on
    (B, N, H, d), the output (B, N, H, d)."""
    o = sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return o.transpose(1, 2)


def flash_attention_bnhd_bwd_reference(q, k, v, g):
    """The VJP of ``flash_attention_bnhd`` as ``_flash_bnhd_bwd`` (:1054)
    writes it out, in fp32: p = softmax(q·kᵀ·d^-½); dv = pᵀ g; dp = g vᵀ;
    ds = p ⊙ (dp − rowsum(dp ⊙ p)) · d^-½; dq = ds k; dk = dsᵀ q; each
    rounded to its input's dtype. There is no backward kernel, as in JAX."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float().transpose(1, 2) for t in (q, k, v, g))  # (B, H, N, d)
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return tuple(t.transpose(1, 2).to(x.dtype) for t, x in ((dq, q), (dk, k), (dv, v)))


def _flash_kernel_fn(entry: str):
    """The C entry point: four pointers, four ints (B, N, H, d), nine
    strides, the scale, the device and the stream."""
    from vtp_tpu_torch import _build

    fn = getattr(_build.load_library(), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it in place (a contiguous head dim, every
    row 16-byte aligned), else a contiguous copy."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1]):
        return t
    return t.contiguous()


def _launch_flash(q, k, v, bnhd: bool) -> torch.Tensor:
    if not _flash_shapes_ok(q, k, v):
        raise ValueError(f"the flash attention kernel takes three bf16 tensors of one 4-d shape "
                         f"with head dim in {FLASH_HEAD_DIMS}; got {tuple(q.shape)} {q.dtype}, "
                         f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("q, k and v must be on one device")
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    if bnhd:
        B, N, H, d = q.shape
        order = (0, 1, 2)
        out = torch.empty((B, N, H * d), dtype=q.dtype, device=dev)
        entry, name = FLASH_BNHD_ENTRY, FLASH_BNHD_NAME
    else:
        B, H, N, d = q.shape
        order = (0, 2, 1)
        out = torch.empty((B, H, N, d), dtype=q.dtype, device=dev)
        entry, name = FLASH_ENTRY, FLASH_NAME
    strides = [t.stride(i) for t in (q, k, v) for i in order]
    rc = _flash_kernel_fn(entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 B, N, H, d, *strides, d ** -0.5, dev.index,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    count_launch(name)
    return out.view(B, N, H, d) if bnhd else out


def _flash_bnhd_forward(q, k, v) -> torch.Tensor:
    if on_kernel_device(q):
        return _launch_flash(q, k, v, bnhd=True)
    return flash_attention_bnhd_reference(q, k, v)


def _flash_forward(q, k, v) -> torch.Tensor:
    if on_kernel_device(q):
        return _launch_flash(q, k, v, bnhd=False)
    return flash_attention_reference(q, k, v)


class _FlashAttentionBNHD(torch.autograd.Function):
    """The differentiable ``flash_attention_bnhd`` (its ``custom_vjp``): the
    forward picks the kernel or the plain version by device, the backward
    is the plain adjoint on either."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _flash_bnhd_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return flash_attention_bnhd_bwd_reference(*ctx.saved_tensors, g)


def flash_attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over (B, N, H, d) q, k, v -> (B, N, H, d),
    differentiable: the kernel on a CUDA tensor (bf16, d in 32/64/128),
    the plain version on a CPU tensor."""
    if q.dim() != 4 or not tuple(q.shape) == tuple(k.shape) == tuple(v.shape):
        raise ValueError(f"q, k, v must share one (B, N, H, d) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _FlashAttentionBNHD.apply(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    is_causal: bool = False) -> torch.Tensor:
    """Non-causal attention over (B, H, N, d) q, k, v -> (B, H, N, d): the
    kernel on a CUDA tensor (bf16, d in 32/64/128; strided views are read
    in place), the plain version on a CPU tensor. Like the JAX function it
    has no backward, so it raises when an input asks for a gradient."""
    if is_causal:
        raise ValueError("flash_attention is non-causal")
    if q.dim() != 4 or not tuple(q.shape) == tuple(k.shape) == tuple(v.shape):
        raise ValueError(f"q, k, v must share one (B, H, N, d) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (nor has the JAX function); "
                           "differentiate through sdpa_reference instead")
    return _flash_forward(q, k, v)
