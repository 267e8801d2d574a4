"""FSDP/ZeRO-3 sharding of the train state over the ``data`` axis (port of
``vtp_tpu/parallel/fsdp.py``).

The shape rules are the JAX package's, with its exact outputs on the same
tree (``_add_data_axis``, ``fsdp_partition_specs``, ``fsdp_state_specs``,
``sharded_bytes``): every leaf of at least ``DEFAULT_MIN_ELEMS`` elements
shards its largest divisible dim over ``data`` (with ``tensor_parallel``,
a dim other than its model dim). A tree is nested dicts, lists or tuples of
tensors or arrays (anything with ``shape`` and ``dtype``); a spec is a
tuple of axis names (or None) a dim.

``shard_state`` applies them to a ``TrainState`` as JAX's ZeRO-3 does (its
:10-16): each rank keeps only its slab of every sharded leaf of the
parameters, of the teacher and of both Adam moments, and the optimizer's
leaf is the module's slab itself. A module reads a sharded parameter whole
through one autograd function (``gather_param``, reached from the module's
own attribute access): its forward all-gathers the slab over ``data``, its
backward reduce-scatters the gradient to the slab. No whole parameter is
kept: each read gathers anew, the backward re-gathers what the forward saved
(``saved_whole_tensors``: a saved whole parameter, or its cast, is packed as
its slab), and a checkpointed block's recompute gathers inside the block.
So a rank holds ``sharded_bytes`` of its state (over a model axis, with the
moments cut as their parameters), and beyond it the activations and the
whole tensors of the one weight in use. The teacher's forward gathers its
slabs without gradient, and its EMA runs on the slabs.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from vtp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    AxisGroup,
    axis_group,
    mesh_axis_size,
)
from vtp_tpu_torch.parallel.sharding import (
    CALLS,
    ShardLayout,
    _gather_dim,
    _reduce_scatter_dim,
    _set_leaf,
    leaf_spec,
)

# leaves smaller than this stay replicated: the all-gather latency for
# tiny tensors (norm scales, biases) outweighs the bytes saved
DEFAULT_MIN_ELEMS = 2**16

Spec = tuple


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if tree is None:  # an absent leaf (a bias-free layer), as in a JAX pytree
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        out = [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x) and not any(
        isinstance(e, tuple) and not all(isinstance(a, str) for a in e) for e in x)


def _shape(leaf: Any) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _add_data_axis(spec: Spec, shape, n_shards: int, min_elems: int) -> Spec:
    """Assign DATA_AXIS to the largest unsharded, divisible dim of
    ``shape`` (largest first, so depth-stacked block kernels shard their
    big feature axes, not the depth axis)."""
    if int(np.prod(shape)) < min_elems or not shape:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is None and shape[i] % n_shards == 0 and shape[i] >= n_shards:
            entries[i] = DATA_AXIS
            return tuple(entries)
    return spec


def fsdp_partition_specs(tree: Any, n_shards: int, *, base_specs: Optional[Any] = None,
                         min_elems: int = DEFAULT_MIN_ELEMS) -> Any:
    """A spec tree sharding every large leaf over ``data``; ``base_specs``
    (e.g. the tensor-parallel rules) is composed with, FSDP picking a
    different dim."""
    if base_specs is None:
        base_specs = _tree_map(lambda leaf: (None,) * len(_shape(leaf)), tree)
    return _tree_map(lambda leaf, spec: _add_data_axis(spec, _shape(leaf), n_shards, min_elems),
                     tree, base_specs)


def fsdp_state_specs(state: Dict[str, Any], n_shards: int, *, tensor_parallel: bool = False,
                     min_elems: int = DEFAULT_MIN_ELEMS) -> Dict[str, Any]:
    """Spec tree for a train-state dict: ``params`` / ``teacher`` / the
    optimizer state (``opt_state``) sharded, everything else replicated.
    ``tensor_parallel`` first applies the Megatron rules
    (``sharding.leaf_spec``, on port leaf names) to ``params`` and
    ``teacher``, given as flat dicts by name."""

    def specs_for_params(p: Any) -> Any:
        base = ({k: leaf_spec(k, len(_shape(v))) for k, v in p.items()}
                if tensor_parallel else None)
        return fsdp_partition_specs(p, n_shards, base_specs=base, min_elems=min_elems)

    def walk(key: str, node: Any) -> Any:
        if key in ("params", "teacher"):
            return specs_for_params(node)
        if key == "opt_state":
            return fsdp_partition_specs(node, n_shards, min_elems=min_elems)
        return _tree_map(lambda leaf: (None,) * len(_shape(leaf)), node)

    return {k: walk(k, v) for k, v in state.items()}


def _itemsize(leaf: Any) -> int:
    dtype = leaf.dtype
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def sharded_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes a rank holds of ``tree`` under ``specs``; ``mesh`` is a
    DeviceMesh or a dict of axis sizes."""
    sizes = (dict(mesh) if isinstance(mesh, dict)
             else {a: mesh_axis_size(mesh, a) for a in (DATA_AXIS, MODEL_AXIS)})
    total = 0

    def leaf_bytes(leaf, spec):
        nonlocal total
        n = math.prod(_shape(leaf) or (1,))
        denom = 1
        for entry in spec:
            if entry is None:
                continue
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                denom *= sizes.get(name, 1)
        total += n * _itemsize(leaf) // denom

    _tree_map(leaf_bytes, tree, specs)
    return total


def train_state_tree(state) -> Dict[str, Any]:
    """A ``TrainState`` as the tree ``fsdp_state_specs`` takes, each leaf in
    its whole (global) shape: ``params`` (the trained leaves by name),
    ``teacher`` (by the same names), the optimizer's ``mu`` / ``nu`` under
    ``opt_state``, and the centers. A leaf that a distributed state holds
    as a slab stands as a meta tensor of the whole shape."""
    layout = getattr(state, "layout", None)

    def whole(tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        if layout is None:
            return dict(tensors)
        return {n: torch.empty(layout.full_shape(n, t.shape), dtype=t.dtype, device="meta")
                if layout.is_sharded(n, t.ndim) else t for n, t in tensors.items()}

    opt = state.optimizer
    tree: Dict[str, Any] = {"params": whole(opt.leaves),
                            "opt_state": {"mu": whole(opt.mu), "nu": whole(opt.nu)}}
    if state.teacher is not None:
        tree["teacher"] = whole(state.teacher.state_dict())
        tree["centers"] = {"dino": state.dino_center, "ibot": state.ibot_center}
    return tree


def held_specs(specs: Dict[str, Any]) -> Dict[str, Any]:
    """``specs`` (``fsdp_state_specs``) as ``shard_state`` lays the state out:
    the moments cut as their parameters. The same tree at a model axis of 1;
    over a model axis, JAX's moments take no model dim (its :104-108) while
    this port's are cut with their parameters."""
    params = specs["params"]
    return dict(specs, opt_state={"mu": dict(params), "nu": dict(params)})


# ------------------------------------------------------- reading a slab whole


def _gather_whole(slab: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """Every rank's slab concatenated along ``dim`` into a new contiguous
    tensor, not a view: ``_pack`` finds a gathered parameter as the base of
    what autograd saves."""
    return _gather_dim(slab, g, dim).contiguous()


class _GatherParam(torch.autograd.Function):
    """A slab all-gathered along ``dim`` into the whole (contiguous)
    parameter; backward reduce-scatters the gradient back to the slab."""

    @staticmethod
    def forward(ctx, slab, g, dim):
        ctx.slab, ctx.g, ctx.dim = slab, g, dim
        return _gather_whole(slab, g, dim)

    @staticmethod
    def backward(ctx, grad):
        CALLS["fsdp_reduce_scatter"] += 1
        return _reduce_scatter_dim(grad, ctx.g, ctx.dim).contiguous(), None, None


def gather_param(slab: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """The whole parameter of ``slab`` (a collective over ``g``)."""
    CALLS["fsdp_gather"] += 1
    return _GatherParam.apply(slab, g, dim)


class _Whole:
    """A saved whole parameter (or its cast), kept as its slab until the
    backward reads it: ``unpack`` gathers it again."""

    __slots__ = ("slab", "g", "dim", "dtype", "size", "stride", "offset")

    def __init__(self, node, t: torch.Tensor):
        self.slab, self.g, self.dim = node.slab, node.g, node.dim
        self.dtype, self.size, self.stride, self.offset = (
            t.dtype, t.size(), t.stride(), t.storage_offset())

    def unpack(self) -> torch.Tensor:
        CALLS["fsdp_regather"] += 1
        whole = _gather_whole(self.slab, self.g, self.dim).to(self.dtype)
        return whole.as_strided(self.size, self.stride, self.offset)


def _pack(t: torch.Tensor):
    """A tensor that autograd saves: a view of a gathered parameter, or of
    its cast (``.to``, which keeps the whole's contiguous layout), becomes
    a ``_Whole``; anything else is kept."""
    node = (t if t._base is None else t._base).grad_fn
    if type(node).__name__ == "ToCopyBackward0":
        node = node.next_functions[0][0]
    return _Whole(node, t) if isinstance(node, _GatherParam._backward_cls) else t


def _unpack(x):
    return x.unpack() if isinstance(x, _Whole) else x


def saved_whole_tensors():
    """The context a forward of a ZeRO-3 state runs in: every whole
    parameter that autograd would save for the backward is saved as its
    slab and gathered again when the backward reads it."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


_ZERO3_CLASSES: Dict[type, type] = {}


def _zero3_class(cls: type) -> type:
    """``cls`` whose attribute access of a sharded parameter (named in the
    instance's ``_zero3``) returns it whole through ``gather_param``."""
    if cls not in _ZERO3_CLASSES:
        def __getattr__(self, name):
            shards = self.__dict__.get("_zero3")
            if shards is not None and name in shards:
                return gather_param(self._parameters[name], *shards[name])
            return cls.__getattr__(self, name)

        _ZERO3_CLASSES[cls] = type(f"ZeRO3{cls.__name__}", (cls,),
                                   {"__getattr__": __getattr__, "__module__": __name__})
    return _ZERO3_CLASSES[cls]


def _owner(root: nn.Module, name: str):
    *path, leaf = name.split(".")
    return root.get_submodule(".".join(path)) if path else root, leaf


@torch.no_grad()
def _shard_leaf(root: nn.Module, name: str, g: AxisGroup, dim: int) -> torch.Tensor:
    """``root``'s parameter ``name`` replaced by this rank's slab of it along
    ``dim``, read whole through ``gather_param``. Returns the slab."""
    module, leaf = _owner(root, name)
    if leaf not in module._parameters:
        raise ValueError(f"{name}: only parameters are sharded (a buffer of "
                         f"{getattr(module, leaf).numel()} elements is not)")
    _set_leaf(root, name, module._parameters[leaf].chunk(g.size, dim)[g.rank].clone())
    shards = module.__dict__.setdefault("_zero3", {})
    shards[leaf] = (g, dim)
    if type(module) not in _ZERO3_CLASSES.values():
        module.__class__ = _zero3_class(type(module))
    return module._parameters[leaf]


class FSDP:
    """A ZeRO-3 train state's data-axis sharding: each sharded leaf's data dim
    by name (``dims``), over the layout's data axis."""

    def __init__(self, layout: ShardLayout):
        self.layout = layout

    @property
    def dims(self) -> Dict[str, int]:
        return self.layout.fsdp

    def reduce_grads(self, names, grads):
        """Each gradient summed over the data axis: a sharded leaf's came out
        of its gathers' backward already summed and cut to the slab
        (reduce-scatter); the others are all-reduced whole."""
        from vtp_tpu_torch.train.optim import all_reduce_flat

        out = list(grads)
        rest = [i for i, n in enumerate(names) if n not in self.dims]
        for i, g in zip(rest, all_reduce_flat([out[i] for i in rest], self.layout.data)):
            out[i] = g
        return out


def shard_state(state, mesh, specs: Dict[str, Any]):
    """Shard ``state`` (a ``TrainState``, whole or spread over ``mesh`` by
    ``train.step.distribute_state``) over ``mesh``'s data axis in place, as
    ``specs`` says: ``fsdp_state_specs(train_state_tree(state), n_data,
    tensor_parallel=n_model > 1)``. Every parameter of the student and the
    teacher with a data dim there becomes this rank's slab (the optimizer's
    leaf is the student's slab itself), and so do its two moments. Returns
    the state."""
    data = axis_group(mesh, DATA_AXIS)
    layout = getattr(state, "layout", None)
    if layout is None:
        layout = ShardLayout.for_config(state.model.config, mesh)
        layout.model = None
        state.model.shard_layout = layout
    dims: Dict[str, int] = {}
    for part in ("params", "teacher"):
        for n, spec in specs.get(part, {}).items():
            if DATA_AXIS not in spec:
                continue
            dim = spec.index(DATA_AXIS)
            if dims.setdefault(n, dim) != dim:
                raise ValueError(f"{n}: the parameter and the teacher shard different dims")
    if layout.model is not None and layout.model.size > 1:
        for n, dim in dims.items():
            ndim = len(specs["params"].get(n) or specs["teacher"][n])
            if leaf_spec(n, ndim, layout.whole)[dim] == MODEL_AXIS:
                raise ValueError(f"{n}: data dim {dim} is its model dim; compute the specs "
                                 f"with fsdp_state_specs(..., tensor_parallel=True)")
    opt = state.optimizer
    layout.fsdp = dims
    layout.data = data
    head = state.dino_head
    for n, dim in dims.items():
        if n in opt.leaves:
            root, name = ((head, n[len("dino_head."):]) if n.startswith("dino_head.")
                          else (state.model, n))
            opt.leaves[n] = _shard_leaf(root, name, data, dim)
            opt.mu[n] = opt.mu[n].chunk(data.size, dim)[data.rank].clone()
            opt.nu[n] = opt.nu[n].chunk(data.size, dim)[data.rank].clone()
        if state.teacher is not None and n in specs.get("teacher", {}):
            _shard_leaf(state.teacher, n, data, dim)
    state.fsdp = FSDP(layout)
    state.layout = layout
    return state
