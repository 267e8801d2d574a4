"""Context parallelism of the attention op (port of
``vtp_tpu/ops/ring_attention.py``): the ring and Ulysses arms.

Each rank of a ``seq`` axis holds N/S of a crop's tokens through the block
stack (``models/blocks.run_blocks`` splits them) and calls one of these
per-rank bodies on its (B, N/S, H, d) q, k and v:

  * ``ring_attention_local`` (``_ring_scan_fwd`` :61, ``_ring_sdpa`` :100):
    the q shard stays put and the K/V shards travel one hop round the ring
    at a time (``parallel.sharding.ppermute``) while an online softmax
    accumulates in fp32 (``_NEG_BIG`` floors the running max, so a key
    block that ``n_valid`` masks whole is a no-op). It is one autograd
    function: the forward keeps only q, k, v, the output and the per-row
    log-sum-exp, and the backward runs its own ring, each block's dK/dV
    travelling with it and reaching home after S hops. The final K/V
    rotation of either ring feeds nothing and is skipped (the JAX package
    makes it to keep its scan's carry): S - 1 K/V hops in the forward; S - 1
    K/V hops and S dK/dV hops in the backward. A backward hop moves 4
    buffers (K and V in their dtype, dK and dV in fp32): about 3x a forward
    hop's bytes for bf16 inputs.
  * ``ulysses_attention_local`` (:237): an all-to-all turns the token shards
    into head shards (B, N, H/S, d), full-N fp32 softmax attention runs on
    them (``n_valid`` masks key columns) and the inverse all-to-all turns
    the output back; autograd differentiates it.

``n_valid`` counts valid GLOBAL key columns (0 = all valid); after t hops
the resident K/V block started on rank ``(rank - t) mod S``. The gates
``ring_supported`` and ``ulysses_supported`` take a rank's local shapes and
its ``AxisGroup``: the batch is already the data shard's and the heads the
model shard's (CP x TP), so of the JAX gates' divisibility conditions
(:175-210, :272-282) there remain an axis of more than one rank, ``n_valid``
within the global tokens and, for Ulysses, the rank's heads dividing the
axis. ``ring_attention`` is the eager entry on whole (B, N, H, d) tensors
that every rank of the group holds.

The per-hop products are fp32 ``torch.matmul``s, as the JAX package's are
``einsum``s outside any Pallas kernel: on the card they run in cuBLAS (TF32
off, the port's default).
"""

from __future__ import annotations

from typing import Optional

import torch

from vtp_tpu_torch.ops.attention import sdpa_reference
from vtp_tpu_torch.parallel.mesh import AxisGroup
from vtp_tpu_torch.parallel.sharding import (
    all_to_all,
    gather_with_grad,
    ppermute,
    split_seq,
    unsplit_seq,
)

# Finite stand-in for -inf in the online-softmax max (:49)
_NEG_BIG = -1e30


def _masked_scores(qf: torch.Tensor, kf: torch.Tensor, scale: float, n_valid: int,
                   col0: int) -> torch.Tensor:
    """(B, H, Nq, Nk) fp32 scores of (B, H, Nq, d) q against (B, H, Nk, d) k
    whose first key is global column ``col0``; columns >= ``n_valid`` at
    -inf when ``n_valid`` is set (``_global_col_mask`` :52)."""
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if n_valid:
        col = torch.arange(col0, col0 + kf.shape[-2], device=s.device)
        s = s.masked_fill(col >= n_valid, float("-inf"))
    return s


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, N, H, d) in any dtype -> (B, H, N, d) fp32, contiguous."""
    return x.transpose(1, 2).float().contiguous()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, g: AxisGroup, scale: float, n_valid: int):
        S, nl = g.size, q.shape[1]
        qf = _heads_first(q)
        acc = torch.zeros_like(qf)
        m = torch.full(qf.shape[:-1], _NEG_BIG, device=q.device)
        l = torch.zeros_like(m)
        kv = torch.stack([k, v])
        for t in range(S):
            src = (g.rank - t) % S
            kf, vf = _heads_first(kv[0]), _heads_first(kv[1])
            s = _masked_scores(qf, kf, scale, n_valid, src * nl)
            m_new = torch.maximum(m, s.amax(-1).clamp_min(_NEG_BIG))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vf)
            m = m_new
            if t < S - 1:
                kv = ppermute(kv, g, 1)
        o = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.g, ctx.scale, ctx.n_valid = g, scale, n_valid
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        g, scale, n_valid = ctx.g, ctx.scale, ctx.n_valid
        S, nl = g.size, q.shape[1]
        qf, dof = _heads_first(q), _heads_first(do)
        # delta_i = dO_i . O_i, the softmax normalisation's adjoint
        delta = (dof * _heads_first(o)).sum(-1)
        dq = torch.zeros_like(qf)
        kv = torch.stack([k, v])
        dkv = torch.zeros((2, *qf.shape), device=q.device)  # (2, B, H, Nl, d) fp32
        for t in range(S):
            src = (g.rank - t) % S
            kf, vf = _heads_first(kv[0]), _heads_first(kv[1])
            s = _masked_scores(qf, kf, scale, n_valid, src * nl)
            p = torch.exp(s - lse[..., None])  # from the saved global lse
            dkv[1] += torch.matmul(p.transpose(-1, -2), dof)
            ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None]) * scale
            dq += torch.matmul(ds, kf)
            dkv[0] += torch.matmul(ds.transpose(-1, -2), qf)
            if t < S - 1:  # the last K/V rotation would feed nothing
                kv = ppermute(kv, g, 1)
            dkv = ppermute(dkv, g, 1)
        back = lambda x, like: x.transpose(1, 2).to(like.dtype)
        return back(dq, q), back(dkv[0], k), back(dkv[1], v), None, None, None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group: AxisGroup,
                         *, scale: Optional[float] = None, n_valid: int = 0) -> torch.Tensor:
    """One rank's ring attention over its (B, N/S, H, d) token shards of q,
    k and v (``_ring_attention_local`` :159); ``n_valid`` masks global key
    columns. Every rank of ``group`` calls it on shards of the same shape."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, group, float(scale), int(n_valid))


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            group: AxisGroup, *, scale: Optional[float] = None,
                            n_valid: int = 0) -> torch.Tensor:
    """One rank's Ulysses attention (``_ulysses_attention_local`` :237): the
    all-to-all to (B, N, H/S, d) head shards, full-N fp32 softmax attention
    with key columns >= ``n_valid`` masked, the output cast to q's dtype and
    the inverse all-to-all."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q, k, v = (all_to_all(x, group, 2, 1) for x in (q, k, v))
    s = _masked_scores(_heads_first(q), _heads_first(k), scale, n_valid, 0)
    o = torch.matmul(torch.softmax(s, dim=-1), _heads_first(v)).transpose(1, 2).to(q.dtype)
    return all_to_all(o, group, 1, 2)


def gathered_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             group: AxisGroup, n_valid: int = 0,
                             precision: str = "float32") -> torch.Tensor:
    """A rank's (B, N/S, H, d) queries against every rank's keys and values,
    gathered (their gradients summed back over the group): the attention of
    a context-parallel block where neither arm is taken (``"ulysses"`` with
    heads that do not divide the axis), as the JAX package then runs its
    local attention on the whole token dim."""
    k, v = (gather_with_grad(x, group, 1) for x in (k, v))
    o = sdpa_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       n_valid=n_valid, precision=precision)
    return o.transpose(1, 2)


def ring_supported(q: torch.Tensor, group: Optional[AxisGroup], n_valid: int = 0) -> bool:
    """Whether a rank's (B, N/S, H, d) shard rides the ring: an axis of more
    than one rank and ``0 <= n_valid <= N`` (``ring_supported`` :175)."""
    if group is None or group.size <= 1:
        return False
    return 0 <= n_valid <= q.shape[1] * group.size


def ulysses_supported(q: torch.Tensor, group: Optional[AxisGroup], n_valid: int = 0) -> bool:
    """The ring's conditions and the rank's heads dividing the axis (under
    CP x TP the rank holds H / model heads; ``ulysses_supported`` :272)."""
    return ring_supported(q, group, n_valid) and q.shape[2] % group.size == 0


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group: AxisGroup,
                   scale: Optional[float] = None, n_valid: int = 0) -> torch.Tensor:
    """Bidirectional attention over whole (B, N, H, d) q, k and v that every
    rank of ``group`` holds, its token dim split over the group (``ring_attention``
    :309): each rank runs the ring on its N/S tokens and the output is
    gathered, so every rank returns the whole (B, N, H, d) result (and
    differentiates as the one-process attention). Raises ``ValueError``
    when N does not divide by the group."""
    if q.shape[1] % group.size:
        raise ValueError(f"N={q.shape[1]} must divide by {group.size} ({group.name})")
    q, k, v = (split_seq(x, group, 1) for x in (q, k, v))
    return unsplit_seq(ring_attention_local(q, k, v, group, scale=scale, n_valid=n_valid),
                       group, 1)
