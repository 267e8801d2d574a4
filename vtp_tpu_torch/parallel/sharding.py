"""Tensor-parallel layouts and collectives (port of
``vtp_tpu/parallel/sharding.py``: the Megatron partition rules :1-50, the
sequence-parallel residual layout :111-182, the head-major qkv layout
:203-250 and ``batch_sharding`` :252-258).

The JAX package states tensor parallelism as GSPMD sharding hints and lets
XLA insert the collectives. Here every rank holds plain local tensors (a
kernel's ctypes wrapper takes raw pointers, and the towers call
``ops.ffn.linear`` on a module's weight without ``nn.Linear.forward``), and
the collectives are explicit ``torch.autograd.Function``s over the mesh's
``model`` group:

  * column-parallel (output features over ``model``): qkv, the FFN
    up-projections (w1, w2, fc1, c_fc) and the text ``in_proj``, with their
    biases; entered through ``copy_to_model`` (identity forward, all-reduce
    backward);
  * row-parallel (input features over ``model``): the out-projections
    (proj, out_proj) and the FFN down-projections (w3, fc2, c_proj), left
    through ``reduce_from_model`` (all-reduce forward, identity backward);
    their biases are replicated and added after the reduction;
  * the token embedding over the vocabulary; everything else replicated.

Sequence parallelism (Korthikanti et al. 2022) keeps the residual stream's
token rows split over ``model`` between the GEMM pairs, as
``constrain_residual`` (:159-182) lays it out: the column-parallel entry
becomes an all-gather of the rows and the row-parallel exit a
reduce-scatter. The replicated parameters that act on a rank's rows there
(norms, layer scales, row-parallel biases) pass through ``copy_to_model``
so that their gradients sum over the group. A stream whose rows do not
divide by the group keeps the non-SP layout, as in the JAX package.

A rank's qkv slab is the Q, K and V columns of its own heads
[r*H/tp, (r+1)*H/tp): a canonical packed qkv for H/tp heads, so each
rank's attention is local and takes the fused kernels. In a head-major
trunk that slab is the contiguous column shard, as under GSPMD; canonical
weights (the decoder, the text ``in_proj``, a canonical trunk) are sliced
per head.

Context and pipeline parallelism ride two more collectives here, each an
autograd function over one axis: ``ppermute`` (a cyclic shift of a tensor
to the rank ``shift`` places on; backward the inverse shift) for the ring
attention's K/V hops and the pipeline's stage-to-stage activations, and
``all_to_all`` (JAX's tiled ``all_to_all``; backward the inverse one) for
Ulysses. Both run on ``all_to_all_single`` over the tensor's bytes, with
per-peer split sizes for the shift, one op on every backend (NCCL, and
gloo on CPU or CUDA tensors). ``parallelize_model`` sets a model's
``ContextParallel`` (the seq axis and the arm preference) and
``PipelineParallel`` (the pipe axis) on its trunk and pixel decoder.

``CALLS`` counts each collective's forward calls by name (``ppermute`` and
``all_to_all`` each call, forward or backward, since the ring and the
pipeline call them inside their own backward).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from vtp_tpu_torch.parallel.mesh import (
    CP_MODES,
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    AxisGroup,
    axis_group,
)

# kernels whose *output* features are model-sharded (JAX :27)
_COLUMN = {"qkv", "w1", "w2", "fc1", "c_fc", "in_proj"}
# kernels whose *input* features are model-sharded (JAX :29)
_ROW = {"proj", "w3", "fc2", "c_proj", "out_proj"}
# port module paths whose JAX owner has another name
_JAX_OWNER = {("patch_embed", "proj"): "patch_embed"}
# the towers whose qkv is packed [Q|K|V] and their qkv leaves
_QKV_LEAVES = {"trunk": (".attn.qkv.weight", ".attn.qkv.bias"),
               "pixel_decoder": (".attn.qkv.weight", ".attn.qkv.bias"),
               "text": (".attn.in_proj_weight", ".attn.in_proj_bias")}

CALLS: collections.Counter = collections.Counter()


def qkv_head_major(w: Any, num_heads: int, tp: int, *, inverse: bool = False) -> Any:
    """Permute the packed-qkv columns on the last dim between the canonical
    [Q|K|V] layout and the ``tp``-rank-major layout (``inverse=True``: back
    to canonical). Works on kernels ``(..., in_dim, 3D)`` and biases
    ``(..., 3D)``; for a torch ``Linear`` weight ``(3D, in)`` pass its
    transpose."""
    if tp <= 1:
        return w
    c = int(w.shape[-1])
    D = c // 3
    if 3 * D != c or D % num_heads or num_heads % tp:
        raise ValueError(
            f"qkv feature dim {c} not permutable: needs 3*H*d columns "
            f"with num_heads={num_heads} divisible by tp={tp}")
    lead = tuple(w.shape[:-1])
    if inverse:
        t = w.reshape(*lead, tp, 3, D // tp).swapaxes(-3, -2)
    else:
        t = w.reshape(*lead, 3, tp, D // tp).swapaxes(-3, -2)
    return t.reshape(*lead, c)


def permute_trunk_qkv(trunk: dict, num_heads: int, tp: int, *, inverse: bool = False) -> dict:
    """Copy of a ViT trunk parameter tree (the JAX package's layout, as
    ``convert.from_torch.convert_state_dict`` builds it) with the stacked
    blocks' qkv kernel and bias permuted to (``inverse=False``) or from
    (``inverse=True``) the head-major layout. Every other leaf is shared,
    not copied."""
    if tp <= 1:
        return trunk
    trunk = dict(trunk)
    blocks = dict(trunk["blocks"])
    attn = dict(blocks["attn"])
    qkv = dict(attn["qkv"])
    # a float {kernel, bias} or an int8 {q, scale, bias}: each on its output dim
    for leaf in ("kernel", "q", "scale", "bias"):
        if qkv.get(leaf) is not None:
            qkv[leaf] = qkv_head_major(qkv[leaf], num_heads, tp, inverse=inverse)
    attn["qkv"] = qkv
    blocks["attn"] = attn
    trunk["blocks"] = blocks
    return trunk


def is_trunk_qkv_key(key: str) -> bool:
    """Whether a reference-named state-dict key is a trunk block's qkv
    weight (float, or an int8 one's codes and scales), bias or bias mask."""
    return key.startswith("trunk.blocks.") and key.endswith(
        (".attn.qkv.weight", ".attn.qkv.bias", ".attn.qkv.bias_mask",
         ".attn.qkv.weight.q", ".attn.qkv.weight.scale"))


def permute_qkv_state_dict(sd: dict, num_heads: int, tp: int, *, inverse: bool = False) -> dict:
    """Copy of a reference-named state dict (torch layouts: a ``Linear``
    weight is ``(out, in)``) with the qkv weight, bias and bias mask of the
    trunk's blocks permuted to (``inverse=False``) or from (``inverse=True``)
    the head-major layout. Every other entry is shared."""
    if tp <= 1:
        return sd
    out = dict(sd)
    for key, value in sd.items():
        if is_trunk_qkv_key(key):
            if key.endswith((".weight", ".weight.q")):
                out[key] = qkv_head_major(value.T, num_heads, tp, inverse=inverse).T
            else:
                out[key] = qkv_head_major(value, num_heads, tp, inverse=inverse)
    return out


# ------------------------------------------------------- partition rules


def leaf_spec(name: str, ndim: int, whole: Iterable[str] = ()) -> Tuple[Optional[str], ...]:
    """The JAX rule ``_spec_for`` (:33-50) on a port leaf: ``name`` is its
    state-dict key, in torch layout (a ``Linear`` weight is ``(out, in)``),
    one leaf a layer. Returns one mesh-axis name or None a dim. A leaf of a
    unit in ``whole`` (``whole_units``: a block's attention or FFN, or a
    text block, that holds an int8 weight) is replicated: the unit runs
    whole on every rank. The codes and scales of an int8 weight
    (``<owner>.weight.q`` / ``.scale``) are replicated by the rule itself,
    as JAX's ``{q, scale}`` leaves are; the unit's column bias, which JAX's
    rule still cuts, stays whole with it here. A fused ``w12`` is no
    column owner, so it stays whole too, as in JAX."""
    parts = name.split(".")
    none = (None,) * ndim
    if whole and _unit(name) in whole:
        return none
    kind = parts[-1]
    owner = parts[-2] if len(parts) >= 2 else ""
    owner = _JAX_OWNER.get(tuple(parts[-3:-1]), owner)
    if kind in ("in_proj_weight", "in_proj_bias"):  # the text tower's bare in_proj
        owner, kind = "in_proj", kind[len("in_proj_"):]
    if owner == "token_embedding" and kind == "weight":
        return (MODEL_AXIS,) + none[1:]
    if kind == "weight" and ndim == 2:
        if owner in _COLUMN:
            return (MODEL_AXIS, None)
        if owner in _ROW:
            return (None, MODEL_AXIS)
    if kind == "bias" and owner in _COLUMN:
        return (MODEL_AXIS,) + none[1:]
    return none


def _unit(name: str) -> Optional[str]:
    """The tensor-parallel unit a leaf belongs to: ``<tower>.blocks.<i>.attn``
    or ``.mlp`` (each carries its own ``TensorParallel``), or a text block
    ``<...>.resblocks.<i>``; None outside the block stacks."""
    parts = name.split(".")
    for i, p in enumerate(parts[:-2]):
        if p == "resblocks" and parts[i + 1].isdigit():
            return ".".join(parts[:i + 2])
        if p == "blocks" and parts[i + 1].isdigit():
            return ".".join(parts[:i + 3])
    return None


def whole_units(names: Iterable[str]) -> frozenset:
    """The units (``_unit``) among the state-dict keys ``names`` that hold
    an int8 weight (``utils.quantization.Int8Weight``: ``<weight>.q``)."""
    return frozenset(u for n in names if n.endswith(".q") and (u := _unit(n)) is not None)


def param_partition_specs(sd: Dict[str, Any]) -> Dict[str, Tuple[Optional[str], ...]]:
    """``leaf_spec`` of every entry of a state dict (tensors or arrays),
    its int8 units whole."""
    whole = whole_units(sd)
    return {k: leaf_spec(k, len(v.shape), whole) for k, v in sd.items()}


def _qkv_tower(name: str) -> Optional[str]:
    tower = name.split(".", 1)[0]
    leaves = _QKV_LEAVES.get(tower)
    return tower if leaves is not None and name.endswith(leaves) else None


@dataclasses.dataclass
class ShardLayout:
    """Where each leaf of a model (by port state-dict name) lives on the
    mesh: ``leaf_spec``'s model-axis dim (its units in ``whole`` replicated),
    and ``fsdp``'s data-axis dim by name (``parallel.fsdp.shard_state``: the
    module's tensor, the teacher's and the optimizer's moments alike).
    ``heads`` and ``head_major`` give each tower's head count and its stored
    qkv layout (1 canonical, else the head-major factor), which a qkv slab
    is cut and gathered by."""

    model: Optional[AxisGroup]
    data: Optional[AxisGroup]
    heads: Dict[str, int]
    head_major: Dict[str, int]
    fsdp: Dict[str, int] = dataclasses.field(default_factory=dict)
    whole: frozenset = frozenset()

    def __deepcopy__(self, memo):
        return self

    @classmethod
    def for_config(cls, cfg, mesh) -> "ShardLayout":
        """The layout of a model with config ``cfg`` (a ``VTPConfig``) on ``mesh``."""
        return cls(axis_group(mesh, MODEL_AXIS), axis_group(mesh, DATA_AXIS),
                   {"trunk": cfg.vision_num_heads, "pixel_decoder": cfg.decoder_num_heads,
                    "text": cfg.text_num_heads},
                   {"trunk": cfg.vision_qkv_head_major})

    def spec(self, name: str, ndim: int) -> Tuple[Optional[str], ...]:
        """The leaf's axis a dim: the model axis's rule and its data dim.
        A data dim on a model dim (specs computed without the model rule,
        at a model axis of 1) takes it over."""
        spec = (list(leaf_spec(name, ndim, self.whole)) if self.model is not None
                else [None] * ndim)
        if name in self.fsdp:
            spec[self.fsdp[name]] = DATA_AXIS
        return tuple(spec)

    def is_sharded(self, name: str, ndim: int) -> bool:
        return any(a is not None for a in self.spec(name, ndim))

    def _permute(self, name: str, t: torch.Tensor, inverse: bool) -> torch.Tensor:
        """A canonical qkv leaf to (or from) the tp-rank-major order whose
        contiguous chunks are the ranks' slabs."""
        tower = _qkv_tower(name)
        tp = self.model.size
        hm = self.head_major.get(tower, 1)
        if hm == tp:
            return t
        if hm != 1:
            raise ValueError(f"{name}: a qkv stored head-major for tp={hm} cannot be "
                             f"sliced for a model axis of {tp}")
        heads = self.heads[tower]
        if t.ndim == 2:  # (3D, in): permute its rows
            return qkv_head_major(t.t(), heads, tp, inverse=inverse).t()
        return qkv_head_major(t, heads, tp, inverse=inverse)

    def full_shape(self, name: str, shape) -> Tuple[int, ...]:
        """The whole leaf's shape from a slab's."""
        spec = self.spec(name, len(shape))
        return tuple(n * {MODEL_AXIS: getattr(self.model, "size", 1),
                          DATA_AXIS: getattr(self.data, "size", 1)}.get(a, 1)
                     for n, a in zip(shape, spec))

    @torch.no_grad()
    def slab(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slab of ``full`` (a copy)."""
        spec = self.spec(name, full.ndim)
        t = full
        if MODEL_AXIS in spec and _qkv_tower(name):
            t = self._permute(name, t, inverse=False)
        for dim, axis in enumerate(spec):
            if axis is not None:
                g = self.model if axis == MODEL_AXIS else self.data
                t = t.chunk(g.size, dim)[g.rank]
        return t.contiguous().clone()

    @torch.no_grad()
    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's slab (a collective over the axes
        it is sharded on), in the stored layout."""
        spec = self.spec(name, local.ndim)
        t = local
        for dim, axis in reversed(list(enumerate(spec))):
            if axis is not None:
                g = self.model if axis == MODEL_AXIS else self.data
                t = _gather_dim(t, g, dim)
        if MODEL_AXIS in spec and _qkv_tower(name):
            t = self._permute(name, t, inverse=True)
        return t


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh, cfg) -> Dict[str, torch.Tensor]:
    """This rank's slab of every leaf of a port state dict of a model with
    config ``cfg`` (a ``VTPConfig``), the qkv leaves cut per head."""
    layout = ShardLayout.for_config(cfg, mesh)
    return {k: layout.slab(k, torch.as_tensor(v)) for k, v in sd.items()}


def shard_batch(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous rows (along ``dim``) of a global batch: the
    JAX ``batch_sharding`` (:252), rows over ``data``. Raises when the rows
    do not divide by the data axis."""
    g = axis_group(mesh, DATA_AXIS)
    if g is None:
        return x
    if x.shape[dim] % g.size:
        raise ValueError(f"batch of {x.shape[dim]} rows does not divide over the data "
                         f"axis ({g.size} shards)")
    return x.chunk(g.size, dim)[g.rank]


def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its last row repeated up to a multiple of ``n`` rows (the
    JAX evals' padding of a batch that does not divide, ``zero_shot.py``
    :172-178)."""
    pad = (-x.shape[0]) % n
    return x if not pad else torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])


@torch.no_grad()
def data_parallel_apply(fn, x: torch.Tensor, mesh) -> torch.Tensor:
    """``fn`` on a global batch ``x`` that every rank passes: each rank runs
    its rows of ``x`` (padded to divide over ``mesh``'s data axis) and the
    outputs are all-gathered, so every rank returns ``fn(x)``'s rows."""
    g = axis_group(mesh, DATA_AXIS)
    b = x.shape[0]
    out = fn(pad_rows(x, g.size).chunk(g.size)[g.rank])
    return _gather_dim(out.contiguous(), g, 0)[:b]


# ------------------------------------------------------------ collectives


def _gather_dim(x: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((g.size * x.shape[0], *x.shape[1:]))
    _all_gather_single(out, x, g.group)
    return out if dim == 0 else out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's chunk along ``dim``."""
    x = x.movedim(dim, 0).contiguous()
    if x.shape[0] % g.size:
        raise ValueError(f"{x.shape[0]} rows do not divide over {g.size} ranks")
    out = x.new_empty((x.shape[0] // g.size, *x.shape[1:]))
    _reduce_scatter_single(out, x, g.group)
    return out.movedim(0, dim)


def _all_gather_single(out, x, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_single(out, x, group) -> None:
    if x.is_cuda and dist.get_backend(group) == "gloo":
        # gloo reduce-scatters host tensors only: the whole sum, then this rank's chunk
        full = x.clone()
        dist.all_reduce(full, group=group)
        out.copy_(full.chunk(dist.get_world_size(group))[dist.get_rank(group)])
        return
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def all_reduce_(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """In-place sum of ``x`` over the axis (no autograd)."""
    dist.all_reduce(x, group=g.group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce_(x.contiguous().clone(), g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim``; backward reduce-scatter (SP entry)."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather_dim(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_dim(grad, ctx.g, ctx.dim), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    """Reduce-scatter along ``dim``; backward all-gather (SP exit)."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _reduce_scatter_dim(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.g, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    """A replicated tensor's own chunk along ``dim``; backward all-gather."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return x.chunk(g.size, dim)[g.rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.g, ctx.dim), None, None


class _UnsplitSeq(torch.autograd.Function):
    """All-gather along ``dim`` into a replicated tensor; backward keeps
    the own chunk (every rank's gradient of a replicated value is the same)."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather_dim(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.g.size, ctx.dim)[ctx.g.rank].contiguous(), None, None


class _GatherWithGrad(torch.autograd.Function):
    """All-gather along ``dim`` whose backward sums the gradient over the
    ranks and keeps the own chunk: a loss that each rank computes on the
    gathered tensor differentiates as the sum of the ranks' losses."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather_dim(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_(grad.contiguous().clone(), ctx.g)
        return grad.chunk(ctx.g.size, ctx.dim)[ctx.g.rank].contiguous(), None, None


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor (a view): the
    shift and the all-to-all move bytes, so every dtype takes one path."""
    return x.reshape(-1).view(torch.uint8)


def _shift(x: torch.Tensor, g: AxisGroup, shift: int) -> torch.Tensor:
    """``x`` sent to the rank ``shift`` places on along the axis (cyclic),
    the tensor of the rank ``shift`` places back received: one
    ``all_to_all_single`` whose split sizes send every byte to one peer."""
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel() * x.element_size()
    dst, src = (g.rank + shift) % g.size, (g.rank - shift) % g.size
    dist.all_to_all_single(_bytes(out), _bytes(x),
                           [n if r == src else 0 for r in range(g.size)],
                           [n if r == dst else 0 for r in range(g.size)], group=g.group)
    return out


def _all_to_all(x: torch.Tensor, g: AxisGroup, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` cut into ``g.size`` chunks along
    ``split_dim``, chunk j sent to rank j, the chunks received concatenated
    along ``concat_dim`` in rank order."""
    if x.shape[split_dim] % g.size:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not divide over "
                         f"{g.size} ranks")
    inp = torch.stack(x.chunk(g.size, split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(_bytes(out), _bytes(inp), group=g.group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, shift):
        ctx.g, ctx.shift = g, shift
        return _shift(x, g, shift)

    @staticmethod
    def backward(ctx, grad):
        return ppermute(grad, ctx.g, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split_dim, concat_dim):
        ctx.g, ctx.dims = g, (split_dim, concat_dim)
        return _all_to_all(x, g, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return all_to_all(grad, ctx.g, concat_dim, split_dim), None, None, None


def ppermute(x: torch.Tensor, g: AxisGroup, shift: int = 1) -> torch.Tensor:
    """``x`` shifted ``shift`` ranks on along the axis, cyclically: rank r
    receives rank ``(r - shift) mod size``'s tensor (``jax.lax.ppermute``
    with the permutation ``i -> i + shift``). Every rank passes a tensor of
    the same shape and dtype."""
    CALLS["ppermute"] += 1
    return _Ppermute.apply(x, g, shift)


def all_to_all(x: torch.Tensor, g: AxisGroup, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``."""
    CALLS["all_to_all"] += 1
    return _AllToAll.apply(x, g, split_dim, concat_dim)


def copy_to_model(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    CALLS["copy_to_model"] += 1
    return _CopyToModel.apply(x, g)


def reduce_from_model(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    CALLS["reduce_from_model"] += 1
    return _ReduceFromModel.apply(x, g)


def gather_seq(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    CALLS["gather_seq"] += 1
    return _GatherSeq.apply(x, g, dim)


def reduce_scatter_seq(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    CALLS["reduce_scatter_seq"] += 1
    return _ReduceScatterSeq.apply(x, g, dim)


def split_seq(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    CALLS["split_seq"] += 1
    return _SplitSeq.apply(x, g, dim)


def unsplit_seq(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    CALLS["unsplit_seq"] += 1
    return _UnsplitSeq.apply(x, g, dim)


def gather_with_grad(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    CALLS["gather_with_grad"] += 1
    return _GatherWithGrad.apply(x, g, dim)


# ----------------------------------------------------- the towers under TP


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The model axis a parallelized module runs on, and whether its
    residual streams take the sequence-parallel layout."""

    axis: AxisGroup
    sequence_parallel: bool = False

    @property
    def size(self) -> int:
        return self.axis.size

    def __deepcopy__(self, memo):
        return self

    def seq_split(self, rows: int) -> bool:
        """Whether a stream of ``rows`` token rows takes the SP layout."""
        return self.sequence_parallel and rows % self.axis.size == 0


@dataclasses.dataclass(frozen=True)
class ContextParallel:
    """The seq axis a tower's block stack splits each crop's tokens over,
    and the attention arm preference: "auto" (Ulysses when the rank's heads
    divide the axis, else the ring), "ring" or "ulysses"."""

    axis: AxisGroup
    mode: str = "auto"

    def __deepcopy__(self, memo):
        return self


@dataclasses.dataclass(frozen=True)
class PipelineParallel:
    """The pipe axis a tower's block stack is stage-sharded over."""

    axis: AxisGroup

    def __deepcopy__(self, memo):
        return self


def tp_enter(x: torch.Tensor, tp: Optional[TensorParallel], sp: bool,
             dim: int = 0) -> torch.Tensor:
    """The input of a column-parallel GEMM: ``copy_to_model``, or under SP
    the all-gather of the rows."""
    if tp is None:
        return x
    return gather_seq(x, tp.axis, dim) if sp else copy_to_model(x, tp.axis)


def tp_exit(y: torch.Tensor, tp: Optional[TensorParallel], sp: bool,
            dim: int = 0) -> torch.Tensor:
    """The output of a row-parallel GEMM: ``reduce_from_model``, or under
    SP the reduce-scatter of the rows."""
    if tp is None:
        return y
    return reduce_scatter_seq(y, tp.axis, dim) if sp else reduce_from_model(y, tp.axis)


def sp_param(p: Optional[torch.Tensor], tp: Optional[TensorParallel], sp: bool):
    """A replicated parameter used on a rank's SP rows: its gradient sums
    over the model group."""
    if p is None or tp is None or not sp:
        return p
    return copy_to_model(p, tp.axis)


def _set_leaf(root: nn.Module, name: str, value: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    module = root.get_submodule(".".join(path)) if path else root
    old = getattr(module, leaf)
    if isinstance(old, nn.Parameter):
        setattr(module, leaf, nn.Parameter(value, requires_grad=old.requires_grad))
    else:
        setattr(module, leaf, value)


def parallelize_model(model, mesh, *, head_major: bool = False,
                      sequence_parallel: bool = False, also: Iterable[nn.Module] = (),
                      cp_mode: str = "auto"):
    """Parallelize a ``VTPModel`` in place over ``mesh`` and return it.
    ``also`` are module trees under the model's names (a train state's
    teacher), treated alike.

    Over a model axis (tensor parallelism): every column- and row-parallel
    weight of the trunk, the pixel decoder and the text tower is replaced by
    this rank's slab (a plain tensor), each attention gets its H/tp heads as
    a canonical packed qkv (``qkv_head_major = 1``), and each parallel
    module carries the ``TensorParallel`` it calls its collectives on.
    ``head_major`` declares the trunk's stored layout head-major for the
    model axis, as the JAX ``tp_head_major`` permutes a canonical trunk:
    the slabs are the same, the config says ``vision_qkv_head_major = tp``,
    and a gathered checkpoint keeps the head-major columns.

    Over a seq axis of more than one rank (context parallelism) the trunk
    and the pixel decoder get a ``ContextParallel`` with ``cp_mode``; over a
    pipe axis of more than one rank, a ``PipelineParallel``. Their weights
    stay whole on every rank, as in the JAX package; the text tower, which
    has no such arm there, runs whole on every seq or pipe rank.
    ``model.shard_layout`` records where every leaf lives."""
    axis = axis_group(mesh, MODEL_AXIS)
    seq, pipe = axis_group(mesh, SEQ_AXIS), axis_group(mesh, PIPE_AXIS)
    if axis is None and seq is None and pipe is None:
        raise ValueError("parallelize_model needs a mesh with a model, seq or pipe axis")
    if cp_mode not in CP_MODES:
        raise ValueError(f"cp mode {cp_mode!r} not in {CP_MODES}")
    roots = [model, *also]
    layout = ShardLayout.for_config(model.config, mesh)
    if axis is not None:
        _tensor_parallelize(model, roots, axis, layout, head_major, sequence_parallel)
    cp = ContextParallel(seq, cp_mode) if seq is not None and seq.size > 1 else None
    pp = PipelineParallel(pipe) if pipe is not None and pipe.size > 1 else None
    for root in roots:
        for tower in _block_towers(root):
            tower.cp, tower.pp = cp, pp
    model.shard_layout = layout
    return model


def _block_towers(root) -> List[nn.Module]:
    """The trunk and the pixel decoder of a model (or of a teacher's
    ``ModuleDict``), those it has."""
    get = (lambda n: root[n] if n in root else None) if isinstance(root, nn.ModuleDict) \
        else (lambda n: getattr(root, n, None))
    return [t for t in (get("trunk"), get("pixel_decoder")) if t is not None]


def _tensor_parallelize(model, roots, axis: AxisGroup, layout: ShardLayout, head_major: bool,
                        sequence_parallel: bool) -> None:
    """``parallelize_model``'s model axis: the slabs, the per-rank heads and
    each parallel module's ``TensorParallel``. A unit that holds an int8
    weight (``whole_units``) keeps every leaf and every head and runs whole,
    with no model collective, as JAX replicates its ``{q, scale}``; a fused
    ``w12`` stays whole and its FFN takes its own columns of the hidden
    before the cut ``w3``."""
    from vtp_tpu_torch.models.blocks import Attention, Mlp, SwiGLUFFN
    from vtp_tpu_torch.models.text_encoder import ResidualAttentionBlock, TextTransformer

    tp = axis.size
    for tower, h in layout.heads.items():
        if getattr(model, tower, None) is not None and h % tp:
            raise ValueError(f"{tower}: {h} heads do not divide over a model axis of {tp}")
    layout.whole = whole_units(n for r in roots for n in r.state_dict())
    declare = head_major and tp > 1 and model.config.vision_qkv_head_major == 1
    par = TensorParallel(axis, sequence_parallel)
    with torch.no_grad():
        for root in roots:
            for name, t in list(root.state_dict(keep_vars=True).items()):
                if MODEL_AXIS in leaf_spec(name, t.ndim, layout.whole):
                    _set_leaf(root, name, layout.slab(name, t.detach()))
                elif declare and _unit(name) in layout.whole and is_trunk_qkv_key(name):
                    # a whole trunk qkv stored head-major, as JAX's server permutes it
                    perm = (lambda w: qkv_head_major(w.t(), layout.heads["trunk"], tp).t()
                            if name.endswith((".weight", ".weight.q"))
                            else qkv_head_major(w, layout.heads["trunk"], tp))
                    _set_leaf(root, name, perm(t.detach()).contiguous())
    for root in roots:
        for name, m in root.named_modules():
            if isinstance(m, (Attention, SwiGLUFFN, Mlp, ResidualAttentionBlock)) and \
                    _unit(f"{name}.x") in layout.whole:
                if isinstance(m, Attention) and name.startswith("trunk.") and declare:
                    m.cfg = dataclasses.replace(m.cfg, qkv_head_major=tp)
                continue
            if isinstance(m, Attention):
                c = m.cfg
                m.cfg = dataclasses.replace(c, dim=c.dim // tp, num_heads=c.num_heads // tp,
                                            qkv_head_major=1)
            if isinstance(m, (Attention, SwiGLUFFN, Mlp, ResidualAttentionBlock,
                              TextTransformer)):
                m.tp = par
    if declare:
        model.config = model.config.replace(vision_qkv_head_major=tp)
        layout.head_major["trunk"] = tp
    for root in roots:
        trunk = root["trunk"] if isinstance(root, nn.ModuleDict) else root.trunk
        trunk.cfg = dataclasses.replace(trunk.cfg,
                                        qkv_head_major=model.config.vision_qkv_head_major)


def gather_state_dict(module, layout: Optional[ShardLayout] = None) -> Dict[str, torch.Tensor]:
    """A parallelized module's whole state dict in its stored layout (a
    collective: every rank of the mesh calls it); the module's own state
    dict when it is not parallelized. ``layout`` defaults to the module's
    ``shard_layout`` (a teacher takes its student's)."""
    layout = layout if layout is not None else getattr(module, "shard_layout", None)
    sd = module.state_dict()
    if layout is None:
        return sd
    return {k: layout.gather(k, v) if layout.is_sharded(k, v.ndim) else v
            for k, v in sd.items()}
