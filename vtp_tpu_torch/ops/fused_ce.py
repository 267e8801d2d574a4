"""Fused DINO/iBOT cross-entropy over the wide prototype logits.

Port of ``vtp_tpu/ops/fused_ce.py``: ``fused_ce_rows`` (:234) and its
Pallas kernels ``_fwd_kernel``/``_run_fwd`` (:106/:148) and
``_bwd_kernel``/``_run_bwd`` (:190/:200). Their Hopper counterparts are
the hand-written CUDA kernels in ``csrc/fused_ce.cu``;
``fused_ce_fwd_reference`` and ``fused_ce_bwd_reference`` are their plain
PyTorch versions.

Per row of teacher logits t and student logits s (R, C):

    ce = -(U / Z_t) + m_s + log l_s
    U   = sum_c exp((t[c]-center[c])/T_t - m_t) * (s[c]/T_s)
    Z_t = sum_c exp((t[c]-center[c])/T_t - m_t)
    l_s = sum_c exp(s[c]/T_s - m_s)

and the backward is ``ds = g_row * (p_s - p_t) / T_s`` from the saved
(m_t, Z_t, m_s, l_s). The teacher and the center get no gradient (EMA
teacher, state buffer). Unlike the TPU kernel the port takes any R and C.
The wrappers pick by the tensor's device alone: a CUDA tensor launches
the kernel or raises, a CPU tensor runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vtp_tpu_torch.ops.dispatch import count_launch, on_kernel_device

FWD_NAME = "fused_ce_fwd"
BWD_NAME = "fused_ce_bwd"
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_ce_fwd_reference(t: torch.Tensor, s: torch.Tensor, center: torch.Tensor,
                           t_temp: float, s_temp: float) -> Tuple[torch.Tensor, Stats]:
    """Plain forward: per-row CE (R,) fp32 and the stats (m_t, z_t, m_s, l_s)."""
    tp = (t.float() - center.float()) / t_temp
    sp = s.float() / s_temp
    m_t = tp.amax(-1)
    e_t = torch.exp(tp - m_t[:, None])
    z_t = e_t.sum(-1)
    u = (e_t * sp).sum(-1)
    m_s = sp.amax(-1)
    l_s = torch.exp(sp - m_s[:, None]).sum(-1)
    ce = -(u / z_t) + m_s + torch.log(l_s)
    return ce, (m_t, z_t, m_s, l_s)


def fused_ce_bwd_reference(t: torch.Tensor, s: torch.Tensor, center: torch.Tensor,
                           g: torch.Tensor, stats: Stats, t_temp: float,
                           s_temp: float) -> torch.Tensor:
    """Plain backward: ds (R, C) in s's dtype from the row cotangent g (R,)."""
    m_t, z_t, m_s, l_s = stats
    tp = (t.float() - center.float()) / t_temp
    sp = s.float() / s_temp
    p_t = torch.exp(tp - m_t[:, None]) / z_t[:, None]
    p_s = torch.exp(sp - m_s[:, None]) / l_s[:, None]
    return (g.float()[:, None] * (p_s - p_t) / s_temp).to(s.dtype)


def _check(t: torch.Tensor, s: torch.Tensor, center: torch.Tensor) -> None:
    if t.dim() != 2 or t.shape != s.shape:
        raise ValueError(f"t and s must be (R, C) of one shape; got {tuple(t.shape)}, {tuple(s.shape)}")
    if tuple(center.shape) != (t.shape[1],):
        raise ValueError(f"center must be ({t.shape[1]},); got {tuple(center.shape)}")
    if t.dtype != s.dtype or t.dtype not in _SUFFIX:
        raise TypeError(f"t and s must both be bfloat16 or both float32; got {t.dtype}, {s.dtype}")


def _kernel_fn(entry: str, n_ptrs: int):
    from vtp_tpu_torch import _build

    fn = getattr(_build.load_library(), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _device_args(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for x in ts:
        if x.device != dev:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("inputs must be contiguous and 16-byte aligned")


def _launch_fwd(t, s, center, t_temp, s_temp) -> Tuple[torch.Tensor, Stats]:
    center = center.float().contiguous()
    _device_args(t, s, center)
    R, C = t.shape
    out = torch.empty((5, R), dtype=torch.float32, device=t.device)
    ce, m_t, z_t, m_s, l_s = out.unbind(0)
    fn = _kernel_fn(f"vtp_fused_ce_fwd_{_SUFFIX[t.dtype]}", 8)
    rc = fn(t.data_ptr(), s.data_ptr(), center.data_ptr(), ce.data_ptr(), m_t.data_ptr(),
            z_t.data_ptr(), m_s.data_ptr(), l_s.data_ptr(), R, C, float(t_temp), float(s_temp),
            t.device.index, torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused CE forward kernel launch failed: CUDA error {rc}")
    count_launch(FWD_NAME)
    return ce, (m_t, z_t, m_s, l_s)


def _launch_bwd(t, s, center, g, stats, t_temp, s_temp) -> torch.Tensor:
    center = center.float().contiguous()
    g = g.float().contiguous()
    stats = tuple(x.contiguous() for x in stats)
    _device_args(t, s, center)
    if any(x.device != t.device for x in (g, *stats)):
        raise ValueError("all inputs must be on one device")
    R, C = t.shape
    ds = torch.empty_like(s)
    fn = _kernel_fn(f"vtp_fused_ce_bwd_{_SUFFIX[t.dtype]}", 9)
    rc = fn(t.data_ptr(), s.data_ptr(), center.data_ptr(), g.data_ptr(),
            *(x.data_ptr() for x in stats), ds.data_ptr(), R, C, float(t_temp), float(s_temp),
            t.device.index, torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused CE backward kernel launch failed: CUDA error {rc}")
    count_launch(BWD_NAME)
    return ds


def fused_ce_fwd(t, s, center, t_temp, s_temp) -> Tuple[torch.Tensor, Stats]:
    """Per-row CE and stats: the kernel on a CUDA tensor, the plain version on a CPU one."""
    _check(t, s, center)
    if on_kernel_device(t):
        return _launch_fwd(t, s, center, t_temp, s_temp)
    return fused_ce_fwd_reference(t, s, center, t_temp, s_temp)


def fused_ce_bwd(t, s, center, g, stats, t_temp, s_temp) -> torch.Tensor:
    """ds from the saved stats: the kernel on a CUDA tensor, the plain version on a CPU one."""
    _check(t, s, center)
    if on_kernel_device(t):
        return _launch_bwd(t, s, center, g, stats, t_temp, s_temp)
    return fused_ce_bwd_reference(t, s, center, g, stats, t_temp, s_temp)


class _FusedCE(torch.autograd.Function):
    """``fused_ce_rows``'s custom VJP: differentiable in s only."""

    @staticmethod
    def forward(ctx, t, s, center, t_temp, s_temp):
        ce, stats = fused_ce_fwd(t, s, center, t_temp, s_temp)
        ctx.save_for_backward(t, s, center, *stats)
        ctx.temps = (t_temp, s_temp)
        return ce

    @staticmethod
    def backward(ctx, g):
        t, s, center, *stats = ctx.saved_tensors
        ds = fused_ce_bwd(t, s, center, g, tuple(stats), *ctx.temps)
        return None, ds, None, None, None


def fused_ce_rows(t: torch.Tensor, s: torch.Tensor, center: torch.Tensor,
                  t_temp: float, s_temp: float) -> torch.Tensor:
    """Per-row CE (R,) fp32 of the centered, sharpened teacher softmax
    against the student log-softmax; differentiable in ``s`` only."""
    return _FusedCE.apply(t.detach(), s, center.detach(), float(t_temp), float(s_temp))
