"""FSDP/ZeRO-style sharding of the train state over the ``data`` axis (port
of ``vtp_tpu/parallel/fsdp.py``).

The shape rules are the JAX package's, with its exact outputs on the same
tree (``_add_data_axis``, ``fsdp_partition_specs``, ``fsdp_state_specs``,
``sharded_bytes``): every leaf of at least ``DEFAULT_MIN_ELEMS`` elements
shards its largest divisible dim over ``data``. A tree is nested dicts,
lists or tuples of tensors or arrays (anything with ``shape`` and
``dtype``); a spec is a tuple of axis names (or None) a dim.

``shard_state`` applies them to a ``TrainState``: each rank keeps its slab
of every sharded trained leaf and of its Adam moments. The train step
differentiates the modules' whole parameters, reduce-scatters each sharded
gradient to its slab, runs AdamW on the slabs, and all-gathers the updated
slabs into the parameters the next forward reads; the teacher EMA then runs
on the whole tensors, as without FSDP. The parameters and the teacher stay
resident and whole between steps, so only the moments and the master slabs
are divided (ZeRO-2); sharding the parameters as well is not ported. FSDP
runs on a mesh without a model axis (size 1).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from vtp_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_group, mesh_axis_size
from vtp_tpu_torch.parallel.sharding import ShardLayout, _gather_dim, _reduce_scatter_dim, leaf_spec

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


def _nbytes(leaf: Any) -> int:
    return math.prod(_shape(leaf) or (1,)) * _itemsize(leaf)


def resident_bytes(tree: Dict[str, Any], specs: Dict[str, Any], n_shards: int) -> int:
    """Bytes a rank holds of ``tree`` (``train_state_tree``) once
    ``shard_state`` applied ``specs`` over ``n_shards``: not JAX's rule
    (``sharded_bytes``), since the parameters and the teacher stay whole.
    Each parameter sharded over ``data`` adds its slab, and its two Adam
    moments are slabs; every other tensor is whole. Per sharded leaf that is
    2 + 3 / n parameter-sized units against 4 replicated (fp32 moments)."""
    whole = sum(_nbytes(leaf) for leaf in _leaves(tree))
    for name, spec in specs["params"].items():
        if DATA_AXIS not in spec:
            continue
        whole += _nbytes(tree["params"][name]) // n_shards
        for m in ("mu", "nu"):
            b = _nbytes(tree["opt_state"][m][name])
            whole -= b - b // n_shards
    return whole


def _leaves(tree: Any) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def train_state_tree(state) -> Dict[str, Any]:
    """A ``TrainState`` as the tree ``fsdp_state_specs`` takes: ``params``
    (the trained leaves by name), ``teacher`` (by the same names), the
    optimizer's ``mu`` / ``nu`` under ``opt_state``, and the centers."""
    opt = state.optimizer
    tree: Dict[str, Any] = {"params": dict(opt.leaves),
                            "opt_state": {"mu": dict(opt.mu), "nu": dict(opt.nu)}}
    if state.teacher is not None:
        tree["teacher"] = dict(state.teacher.state_dict())
        tree["centers"] = {"dino": state.dino_center, "ibot": state.ibot_center}
    return tree


class FSDP:
    """A train state's data-axis sharding: for each sharded trained leaf its
    dim and the module parameter the forward reads (``full``)."""

    def __init__(self, layout: ShardLayout, full: Dict[str, torch.Tensor]):
        self.layout, self.full = layout, full

    @property
    def dims(self) -> Dict[str, int]:
        return self.layout.fsdp

    def reduce_grads(self, names, grads):
        """Each gradient summed over the data axis: a sharded leaf's as its
        slab (reduce-scatter), the others whole (all-reduce)."""
        data = self.layout.data
        out = []
        rest = []
        for n, g in zip(names, grads):
            if n in self.dims:
                out.append(_reduce_scatter_dim(g, data, self.dims[n]))
            else:
                out.append(g)
                rest.append(len(out) - 1)
        from vtp_tpu_torch.train.optim import all_reduce_flat

        reduced = all_reduce_flat([out[i] for i in rest], data)
        for i, g in zip(rest, reduced):
            out[i] = g
        return out

    @torch.no_grad()
    def refresh(self, state) -> None:
        """The slabs re-cut from the parameters (after a restore filled
        those whole)."""
        for n in self.dims:
            state.optimizer.leaves[n].copy_(self.layout.slab(n, self.full[n]))

    @torch.no_grad()
    def gather_params(self, slabs: Dict[str, torch.Tensor]) -> None:
        """Every sharded parameter all-gathered from the updated slabs."""
        for n, dim in self.dims.items():
            self.full[n].copy_(_gather_dim(slabs[n], self.layout.data, dim))


def shard_state(state, mesh, specs: Dict[str, Any]):
    """Shard ``state`` (a ``TrainState``; data-parallel or not yet
    distributed) over ``mesh``'s data axis by ``specs["params"]``
    (``fsdp_state_specs(train_state_tree(state), n)``), in place: the
    optimizer's sharded leaves and their moments become this rank's slabs.
    Returns the state."""
    if mesh_axis_size(mesh, MODEL_AXIS) > 1:
        raise NotImplementedError("FSDP with a model axis > 1 is not ported")
    data = axis_group(mesh, DATA_AXIS)
    layout = getattr(state, "layout", None)
    if layout is None:
        layout = ShardLayout.for_config(state.model.config, mesh)
        layout.model = None
    dims = {n: spec.index(DATA_AXIS) for n, spec in specs["params"].items()
            if DATA_AXIS in spec}
    layout.fsdp = dims
    layout.data = data
    opt = state.optimizer
    full = {n: opt.leaves[n] for n in dims}
    for n in dims:
        p = opt.leaves[n]
        opt.leaves[n] = layout.slab(n, p).requires_grad_(p.requires_grad)
        opt.mu[n] = layout.slab(n, opt.mu[n])
        opt.nu[n] = layout.slab(n, opt.nu[n])
    state.fsdp = FSDP(layout, full)
    state.layout = layout
    return state

