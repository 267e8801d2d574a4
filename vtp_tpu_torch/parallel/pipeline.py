"""GPipe pipeline parallelism over a block stack (port of
``vtp_tpu/parallel/pipeline.py``: ``pipeline_apply`` :94, ``pipeline_blocks``
:217, ``pp_supported`` :260, ``maybe_pipeline_blocks`` :274; the meshes
are in ``parallel/mesh.py``).

Stage s of a ``pipe`` axis of S ranks runs layers [s * depth / S, (s + 1) *
depth / S) of the stack; every rank keeps every parameter, as in the JAX
package. The schedule is the systolic one: ``n_micro + S - 1`` ticks; at
tick t stage s runs microbatch ``t - s`` (stage 0 takes it from the input,
the others from the activation the stage before sent at tick t - 1), and
the last stage retires microbatch ``t - (S - 1)``. After each tick but the
last every rank shifts its output one stage on (``sharding.ppermute``); a
final all-reduce of the last stage's retired outputs (zeros elsewhere)
hands every rank the result.

In eager PyTorch each rank's autograd engine would order a backward by its
own graph, and ranks that run other stages could then make the backward's
collectives in other orders; a shift whose output a rank never reads would
get no backward at all. So the whole schedule is one autograd function.
Its forward runs the ticks, keeping each of the rank's (microbatch, stage)
graphs; its backward runs the reverse schedule, the same ticks in reverse
with each input gradient shifted one stage back, so every rank makes the
same collectives in the same order: ``n_micro + S - 2`` shifts each way,
the all-reduce of the output (forward) and of the input gradient, which
stage 0 computes (backward), an all-reduce of the gradient of each
differentiable extra input (the layers' shared tables) and one all-gather
of the stages' parameter gradients, so every rank returns every layer's
gradient, as the sequential loop would. The last stage takes the output's
gradient once; the other ranks' copy of it is not read.

A rank in a bubble tick computes nothing (the JAX package computes on
garbage there); it sends a zero buffer, so the shifts stay collective.
With ``n_micro = S`` each rank runs each of its layers ``S`` times on a
microbatch of 1/S of the rows, as many kernel launches a rank as the
sequential loop makes. ``remat`` checkpoints each layer
(``models/blocks.checkpoint_policy``).

``maybe_pipeline_blocks`` is the arm of ``models/blocks.run_blocks``: each
(B, N, D) crop of this data shard cut into ``n_micro = S`` microbatches of
B / S rows (JAX's layout, the data shard's rows already local here), the
crops packed per microbatch, pipelined and put back; None where
``pp_supported`` refuses, and the caller runs the sequential loop.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vtp_tpu_torch.parallel.mesh import AxisGroup
from vtp_tpu_torch.parallel.sharding import _gather_dim, all_reduce_, ppermute


class _Stage:
    """This rank's layers of a stack and how one microbatch runs them."""

    def __init__(self, body: Callable, layers: Sequence[nn.Module], g: AxisGroup,
                 remat: Union[bool, str]):
        from vtp_tpu_torch.models.blocks import checkpoint_policy

        layers = list(layers)
        if len(layers) % g.size:
            raise ValueError(f"depth {len(layers)} must divide by {g.size} stages")
        self.per = len(layers) // g.size
        self.mine = layers[g.rank * self.per:(g.rank + 1) * self.per]
        self.body, self.g = body, g
        self.run = checkpoint_policy(remat)
        self.params = [[p for p in layer.parameters() if p.requires_grad] for layer in layers]
        if len({tuple((p.shape, p.dtype) for p in ps) for ps in self.params}) > 1:
            raise ValueError("the pipeline's layers must hold parameters of the same shapes")

    def __call__(self, x: torch.Tensor, extras: Sequence[torch.Tensor]) -> torch.Tensor:
        for layer in self.mine:
            x = (self.run(self.body, layer, x, *extras) if self.run is not None
                 else self.body(layer, x, *extras))
        return x


def _forward_ticks(stage: _Stage, x_micro: torch.Tensor, extras, keep: bool):
    """The forward schedule: every rank's outputs (n_micro, rows, ...) and,
    with ``keep``, this stage's (input, output) graph of each microbatch."""
    g = stage.g
    S, s, M = g.size, g.rank, x_micro.shape[0]
    outs = torch.zeros_like(x_micro)
    saved: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * M
    idle = torch.zeros_like(x_micro[0])
    buf = None
    for t in range(M + S - 1):
        m = t - s
        send = idle
        if 0 <= m < M:
            inp = x_micro[m] if s == 0 else buf
            if keep:
                inp = inp.detach().requires_grad_()
                with torch.enable_grad():
                    out = stage(inp, extras)
                saved[m] = (inp, out)
                out = out.detach()
            else:
                out = stage(inp, extras)
            if out.shape != idle.shape or out.dtype != idle.dtype:
                raise ValueError(f"a stage maps {tuple(idle.shape)} {idle.dtype} to "
                                 f"{tuple(out.shape)} {out.dtype}: the pipeline needs both equal")
            if s == S - 1:
                outs[m] = out
            send = out
        if t < M + S - 2:
            buf = ppermute(send, g, 1)
    return all_reduce_(outs, g), saved


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage: _Stage, x_micro, n_extras: int, *tensors):
        extras = [e.detach().requires_grad_(e.requires_grad) for e in tensors[:n_extras]]
        outs, saved = _forward_ticks(stage, x_micro, extras, keep=True)
        ctx.stage, ctx.saved_graphs, ctx.extras = stage, saved, extras
        return outs

    @staticmethod
    def backward(ctx, grad_out):
        stage, saved, extras = ctx.stage, ctx.saved_graphs, ctx.extras
        g = stage.g
        S, s, M = g.size, g.rank, grad_out.shape[0]
        mine = [p for layer in range(s * stage.per, (s + 1) * stage.per)
                for p in stage.params[layer]]
        ex = [e for e in extras if e.requires_grad]
        d_params = [torch.zeros_like(p) for p in mine]
        d_extras = [torch.zeros_like(e) for e in ex]
        dx = torch.zeros_like(grad_out)
        idle = torch.zeros_like(grad_out[0])
        gbuf = None
        for t in reversed(range(M + S - 1)):
            m = t - s
            send = idle
            if 0 <= m < M:
                inp, out = saved[m]
                saved[m] = None
                go = grad_out[m] if s == S - 1 else gbuf
                grads = torch.autograd.grad(out, [inp, *mine, *ex], go, allow_unused=True)
                for acc, gr in zip(d_params + d_extras, grads[1:]):
                    if gr is not None:
                        acc += gr
                send = grads[0] if grads[0] is not None else idle
                if s == 0:
                    dx[m] = send
            if t > 0:
                gbuf = ppermute(send, g, -1)
        dx = all_reduce_(dx, g)
        for d in d_extras:
            all_reduce_(d, g)
        it = iter(d_extras)
        d_ex = [next(it) if e.requires_grad else None for e in extras]
        return (None, dx, None, *d_ex, *_gather_stage_grads(d_params, stage))


def _gather_stage_grads(d_params: List[torch.Tensor], stage: _Stage) -> List[torch.Tensor]:
    """Every layer's parameter gradients, in layer order, from each stage's
    own (one all-gather a dtype; the layers of a stack share their shapes)."""
    S = stage.g.size
    out: List[Optional[torch.Tensor]] = [None] * (S * len(d_params))
    by_dtype = {}
    for i, d in enumerate(d_params):
        by_dtype.setdefault(d.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([d_params[i].reshape(-1) for i in idx])
        full = _gather_dim(flat, stage.g, 0).reshape(S, -1)
        for s in range(S):
            off = 0
            for i in idx:
                n = d_params[i].numel()
                out[s * len(d_params) + i] = full[s, off:off + n].view_as(d_params[i])
                off += n
    return out


def pipeline_apply(body: Callable, layers: Sequence[nn.Module], x_micro: torch.Tensor, *,
                   group: AxisGroup, remat: Union[bool, str] = False,
                   extras: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Run a stack of ``layers`` as a pipeline of ``group.size`` stages.

    body: one layer, ``body(layer, x, *extras) -> x`` with the output's
      shape and dtype those of ``x``.
    layers: the stack in order, each an ``nn.Module`` whose parameters
      ``body`` uses; their count must divide by the stages (``ValueError``).
    x_micro: ``(n_micro, rows, ...)`` microbatches, the same on every rank.
    extras: tensors every layer reads (the RoPE tables); their gradients
      sum over the stages.

    Returns the ``(n_micro, rows, ...)`` outputs on every rank. Under grad
    the schedule is one autograd function whose backward hands every rank
    the gradients of the input, the extras and every layer's parameters."""
    stage = _Stage(body, layers, group, remat)
    extras = list(extras)
    params = [p for layer in stage.params for p in layer]
    needs_grad = torch.is_grad_enabled() and (
        x_micro.requires_grad or any(t.requires_grad for t in extras + params))
    if not needs_grad:
        return _forward_ticks(stage, x_micro, extras, keep=False)[0]
    return _Pipeline.apply(stage, x_micro, len(extras), *extras, *params)


def pipeline_blocks(xs_micro: torch.Tensor, blocks: Sequence[nn.Module], ropes, shapes, *,
                    group: AxisGroup, compute_dtype: Optional[torch.dtype] = None,
                    n_valids: Optional[Sequence[int]] = None, remat: Union[bool, str] = False,
                    precision: str = "float32") -> torch.Tensor:
    """The packed-token block stack (``Block.forward_packed``) pipelined:
    ``xs_micro`` (n_micro, rows, D) holds each microbatch's crops packed,
    ``shapes`` their (b, N) a microbatch and ``ropes`` their tables, which
    ride as the pipeline's extra inputs."""
    n_valids = list(n_valids) if n_valids is not None else [n for _, n in shapes]
    present = [i for i, r in enumerate(ropes) if r is not None]
    tables = [t for i in present for t in ropes[i]]

    def body(blk, flat, *tabs):
        rs = list(ropes)
        for j, i in enumerate(present):
            rs[i] = (tabs[2 * j], tabs[2 * j + 1])
        return blk.forward_packed(flat, shapes, rs, n_valids, compute_dtype, precision)

    return pipeline_apply(body, blocks, xs_micro, group=group, remat=remat, extras=tables)


def pp_supported(xs: Sequence[torch.Tensor], group: Optional[AxisGroup], depth: int) -> bool:
    """Whether a depth loop over this data shard's crops ``xs`` pipelines:
    a pipe axis of more than one rank that divides ``depth`` and every
    crop's rows (``pp_supported`` :260, whose global batch divides by pipe
    x data, on a shard's rows)."""
    if group is None or group.size <= 1 or depth % group.size:
        return False
    return all(x.shape[0] % group.size == 0 for x in xs)


def maybe_pipeline_blocks(xs: Sequence[torch.Tensor], blocks: Sequence[nn.Module], ropes,
                          group: AxisGroup, *, n_valids: Optional[Sequence[int]] = None,
                          compute_dtype: Optional[torch.dtype] = None,
                          remat: Union[bool, str] = False, precision: str = "float32"
                          ) -> Optional[List[torch.Tensor]]:
    """The pipelined depth loop over (B_i, N_i, D) crops, or None where
    ``pp_supported`` refuses them: ``n_micro = S`` microbatches of B_i / S
    rows of each crop, packed per microbatch, and the crops put back in
    their order (:274-340)."""
    if not pp_supported(xs, group, len(blocks)):
        return None
    M = group.size
    shapes = [(x.shape[0] // M, x.shape[1]) for x in xs]
    xm = torch.cat([x.reshape(M, -1, x.shape[-1]) for x in xs], dim=1)
    out = pipeline_blocks(xm, blocks, ropes, shapes, group=group, compute_dtype=compute_dtype,
                          n_valids=n_valids, remat=remat, precision=precision)
    res, off = [], 0
    for x, (b, n) in zip(xs, shapes):
        res.append(out[:, off:off + b * n].reshape(x.shape))
        off += b * n
    return res
