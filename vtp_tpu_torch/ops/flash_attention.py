"""Fused qkv-split + qk-RMSNorm + RoPE + attention.

Port of ``vtp_tpu/ops/flash_attention.py``: ``fused_qkv_rope_attention``
(:398) and its Pallas kernel ``_fused_kernel_call`` (:423), whose
Hopper counterpart is the hand-written CUDA kernel in
``csrc/fused_attention.cu``; ``fused_qkv_rope_attention_reference`` is
the plain PyTorch version, the counterpart of ``_fused_reference_impl``
(:282).

The wrapper picks by the tensor's device alone (``ops/dispatch.py``): a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises. The kernel has two arms chosen by dtype: bf16 (the encode) and
exact fp32 (the decode). The TPU kernel's fp32 bf16x3 ("high") arm is
not ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vtp_tpu_torch.ops.attention import sdpa_reference
from vtp_tpu_torch.ops.dispatch import count_launch, on_kernel_device
from vtp_tpu_torch.ops.norms import rms_norm
from vtp_tpu_torch.ops.rope import rope_apply

KERNEL_HEAD_DIM = 64
_ENTRY = {torch.bfloat16: "vtp_fused_qkv_rope_attention_bf16",
          torch.float32: "vtp_fused_qkv_rope_attention_f32"}
# launch-count names, one per arm
ARM_NAME = {torch.bfloat16: "fused_qkv_rope_attention_bf16",
            torch.float32: "fused_qkv_rope_attention_fp32"}


def fused_qkv_rope_attention_reference(
    qkv: torch.Tensor,
    sin: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    num_heads: int,
    q_scale: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    n_valid: int = 0,
    is_causal: bool = False,
) -> torch.Tensor:
    """Plain version: (B, N, 3*H*d) packed [Q|K|V] -> (B, N, H*d)."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    d = D // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, d).unbind(2)
    if q_scale is not None:
        q = rms_norm(q, q_scale).to(qkv.dtype)
        k = rms_norm(k, k_scale).to(qkv.dtype)
    if sin is not None:
        s = sin[None, :, None, :].to(torch.bfloat16)
        c = cos[None, :, None, :].to(torch.bfloat16)
        q = rope_apply(q.to(torch.bfloat16), s, c).to(qkv.dtype)
        k = rope_apply(k.to(torch.bfloat16), s, c).to(qkv.dtype)
    o = sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       is_causal=is_causal, n_valid=n_valid)
    return o.transpose(1, 2).reshape(B, N, D)


def _check(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid) -> None:
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


def _kernel_fn(dtype: torch.dtype):
    from vtp_tpu_torch import _build

    fn = getattr(_build.load_library(), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def _launch(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid, is_causal) -> torch.Tensor:
    B, N, three_d = qkv.shape
    D = three_d // 3
    if D // num_heads != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dim {KERNEL_HEAD_DIM}; got {D // num_heads}")
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
    rc = _kernel_fn(qkv.dtype)(
        ptr(qkv), ptr(sin), ptr(cos), ptr(q_scale), ptr(k_scale), ptr(out),
        B, N, num_heads, n_valid or N, int(bool(is_causal)), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused attention kernel launch failed: CUDA error {rc}")
    count_launch(ARM_NAME[qkv.dtype])
    return out


def fused_qkv_rope_attention(
    qkv: torch.Tensor,
    sin: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    num_heads: int,
    q_scale: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    n_valid: int = 0,
    is_causal: bool = False,
) -> torch.Tensor:
    """(B, N, 3*H*d) packed [Q|K|V] -> (B, N, H*d).

    sin/cos: (N, d) tables with the identity rotation over any prefix,
    or None for no RoPE. q_scale/k_scale: (d,) qk-RMSNorm scales or
    None. n_valid: mask key columns >= n_valid (0 = all valid).
    is_causal: mask key columns > the query row."""
    _check(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid)
    if on_kernel_device(qkv):
        return _launch(qkv, sin, cos, num_heads, q_scale, k_scale, n_valid, is_causal)
    return fused_qkv_rope_attention_reference(qkv, sin, cos, num_heads, q_scale, k_scale,
                                              n_valid, is_causal)
