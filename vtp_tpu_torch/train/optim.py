"""The training optimizer (port of ``vtp_tpu/train/step.py:160``
``make_optimizer``, ``vtp_tpu/dit/train.py:67`` ``make_dit_optimizer``
and ``vtp_tpu/train/optim.py:103`` ``adamw``): clip by global norm, then
AdamW with fp32 moments in optax's update order, under a warmup-cosine
learning rate or, for the DiT without warmup, a constant one.

Per leaf p with gradient g, at step t (the count before this step):

    g  = g if |g|_global < clip else (g / |g|_global) * clip
    mu = (1 - b1) g + b1 mu ;  nu = (1 - b2) g^2 + b2 nu
    u  = (mu / (1 - b1^(t+1))) / (sqrt(nu / (1 - b2^(t+1))) + eps)
    p  = p + lr(t) * -(u + wd p)

With ``moment_dtype="bf16"`` (``scale_by_adam_moments``, :44) the
moments are stored in bf16, rounded to nearest even; the update is
computed in fp32 from the unrounded moments, in the JAX package's order
(``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + ((1 - b2) g) g``).

Every leaf of the JAX package's parameter tree is a leaf here, RoPE
``periods`` included: ``optax.adamw`` there has no mask, so the periods
(zero gradient) are decayed too. The port keeps them as buffers and
hands them to this optimizer as leaves so they are treated alike; in
bf16 the decay step (lr*wd <= 4e-5 relative) is below half an ulp and
leaves them unchanged, as in the JAX package.

Under a mesh the leaves may be rank-local slabs (tensor-parallel weights,
FSDP shards); AdamW is elementwise, and the clip's global norm sums the
squares of each sharded leaf over the axes it is sharded on and counts
each replicated leaf once (``global_norm_sq``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vtp_tpu_torch.parallel.mesh import AxisGroup

# The host-driven gradient accumulators' storage dtypes (``accum_dtype``)
ACCUM_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def warmup_cosine_lr(count: int, peak: float, warmup_steps: int, total_steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, max(total, warmup+1), 0)``
    with warmup = min(warmup_steps, max(total_steps - 1, 0)), in fp32."""
    warmup = min(warmup_steps, max(total_steps - 1, 0))
    decay_steps = max(total_steps, warmup + 1)
    f = np.float32
    if warmup > 0 and count < warmup:
        frac = f(1) - f(count) / f(warmup)
        return float(f(0 - peak) * frac + f(peak))
    c = f(min(count - warmup, decay_steps - warmup))
    cosine = f(0.5) * (f(1) + np.cos(f(math.pi) * c / f(decay_steps - warmup), dtype=f))
    return float(f(peak) * cosine)


def resolve_moment_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """Config string -> the moments' storage dtype: None (the leaf's own,
    ``optax.adamw``) for 'fp32'/'float32'/None, bf16 for 'bf16'/'bfloat16'
    (``vtp_tpu/train/optim.py:126``)."""
    if name in (None, "fp32", "float32"):
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unknown moment_dtype {name!r} (use 'fp32' or 'bf16')")


@torch.no_grad()
def accumulate_grads(g_sum: Sequence[torch.Tensor],
                     grads: Sequence[Optional[torch.Tensor]]) -> None:
    """``g_sum += grads`` in place, each sum added in fp32 and stored in its
    own dtype (the JAX package's host accumulation); a None gradient adds
    nothing."""
    for a, b in zip(g_sum, grads):
        if b is None:
            continue
        if a.dtype == torch.float32:
            a.add_(b.float())
        else:
            a.copy_(a.float() + b.float())


def all_reduce_flat(tensors: Sequence[torch.Tensor], axis: AxisGroup) -> List[torch.Tensor]:
    """Each tensor summed over ``axis``, in one all-reduce a dtype (the
    tensors flattened into one buffer); new tensors, in order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=axis.group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def global_norm_sq(grads: Dict[str, torch.Tensor],
                   sharded_over: Dict[str, Tuple[AxisGroup, ...]]) -> torch.Tensor:
    """The squared global norm of gradients some of which are slabs: the
    leaves sharded over the same axes sum their squares, all-reduced over
    those axes; replicated leaves (absent from ``sharded_over``) count once."""
    parts: Dict[Tuple, List[torch.Tensor]] = {}
    for n, g in grads.items():
        parts.setdefault(tuple(sharded_over.get(n, ())), []).append(g.float().square().sum())
    total = None
    for axes, sums in parts.items():
        s = torch.stack(sums).sum()
        for axis in axes:
            dist.all_reduce(s, group=axis.group)
        total = s if total is None else total + s
    return total


class AdamW:
    """clip_by_global_norm -> AdamW over named leaves. With fp32 moments the
    moment of a leaf has the leaf's dtype, as ``optax.adamw`` gives it; with
    ``moment_dtype="bf16"`` every moment is stored in bf16.
    Each leaf's update is computed in fp32 and rounded to its dtype. Every
    leaf but the bf16 RoPE periods is fp32; for the periods (zero
    gradient, zero moments) the update is the decay alone, below half an
    ulp, so they stay unchanged as in the JAX package."""

    def __init__(self, leaves: Dict[str, torch.Tensor], *, learning_rate: float,
                 warmup_steps: int, total_steps: int, weight_decay: float, b1: float,
                 b2: float, grad_clip: float, eps: float = 1e-8,
                 moment_dtype: Optional[str] = "fp32", constant_lr: bool = False):
        """``constant_lr``: the learning rate stays at ``learning_rate``
        (the DiT optimizer without warmup) instead of the warmup-cosine."""
        self.moment_dtype = resolve_moment_dtype(moment_dtype)
        self.leaves = leaves
        self.mu = {n: torch.zeros_like(p, dtype=self.moment_dtype) for n, p in leaves.items()}
        self.nu = {n: torch.zeros_like(p, dtype=self.moment_dtype) for n, p in leaves.items()}
        self.count = 0
        self.lr_args = (learning_rate, warmup_steps, total_steps)
        self.constant_lr = constant_lr
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.grad_clip = grad_clip

    def lr(self, count: Optional[int] = None) -> float:
        if self.constant_lr:
            return float(np.float32(self.lr_args[0]))
        return warmup_cosine_lr(self.count if count is None else count, *self.lr_args)

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]],
             norm_sq: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None
             ) -> torch.Tensor:
        """One update from gradients by leaf name (None or missing = zero).
        Returns the global norm of the unclipped gradients; ``norm_sq`` (the
        gradients by name -> their squared global norm) replaces the plain
        sum of squares when some leaves are slabs."""
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        gs = {n: (grads.get(n) if grads.get(n) is not None else torch.zeros_like(p))
              for n, p in self.leaves.items()}
        if norm_sq is None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in gs.values()))
        else:
            norm = torch.sqrt(norm_sq(gs))
        keep = norm < self.grad_clip
        f = np.float32
        count = self.count + 1
        bc1, bc2 = float(f(1) - f(b1) ** f(count)), float(f(1) - f(b2) ** f(count))
        lr = -self.lr()
        for n, p in self.leaves.items():
            g = gs[n].float()
            g = torch.where(keep, g, (g / norm) * self.grad_clip)
            if self.moment_dtype is None:
                mu = (1 - b1) * g + b1 * self.mu[n].float()
                nu = (1 - b2) * g ** 2 + b2 * self.nu[n].float()
            else:
                mu = b1 * self.mu[n].float() + (1 - b1) * g
                nu = b2 * self.nu[n].float() + (1 - b2) * g * g
            self.mu[n].copy_(mu)
            self.nu[n].copy_(nu)
            pf = p.float()
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.copy_(pf + lr * (u + wd * pf))
        self.count = count
        return norm
