"""Device meshes (port of ``vtp_tpu/parallel/mesh.py``: ``DATA_AXIS``,
``MODEL_AXIS``, ``SEQ_AXIS``, ``PIPE_AXIS``, ``mesh_axis_size``,
``make_mesh`` :17-101, ``make_cp_mesh`` :103-145; and of
``vtp_tpu/parallel/pipeline.py``'s ``make_pipeline_mesh`` and
``make_pp_mesh`` :51-70).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank
of the default process group, laid out as JAX's meshes lay out their
devices, row-major over the axes: in a ``(data, model)`` mesh rank ``i``
sits at ``(i // n_model, i % n_model)``, so the ranks of one model group
are consecutive; ``(data, seq[, model])`` and ``(data, pipe)`` likewise.
It is always passed explicitly; the JAX package's ambient mesh
(``jax.set_mesh``, ``active_mesh``) has no counterpart. So neither has
its context-parallel mode registry (``cp_mode_for``, keyed on a mesh
signature, with ``VTP_CP_MODE`` read once at import): the mode is an
argument of ``parallel.sharding.parallelize_model`` and travels with the
model's ``ContextParallel`` setting. ``AxisGroup`` is what a collective
needs of one axis: its process group, its size and this rank's place on
it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"  # context parallelism: the attention token dim (ops/ring_attention.py)
PIPE_AXIS = "pipe"  # pipeline parallelism: the transformer depth (parallel/pipeline.py)
CP_MODES = ("auto", "ring", "ulysses")


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (1 when absent or mesh is None)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _device_mesh(shape, names, device):
    """A DeviceMesh of ``shape`` named ``names`` over every rank; raises
    ``ValueError`` when the shape's size is not the world size (one
    process without a group is a world of 1)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} != {world} ranks")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "parallel.multihost.init_distributed first")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, tuple(shape), mesh_dim_names=names)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device="cuda"):
    """A ``(data, model)`` DeviceMesh over the default process group's
    ranks (``parallel.multihost.init_distributed`` first). ``n_data``
    defaults to every rank over ``n_model``."""
    if n_data is None:
        n_data = (dist.get_world_size() if dist.is_initialized() else 1) // n_model
    return _device_mesh((n_data, n_model), (DATA_AXIS, MODEL_AXIS), device)


def make_cp_mesh(n_seq: int, n_data: int = 1, n_model: int = 1, device="cuda"):
    """A ``(data, seq)`` context-parallel DeviceMesh, or ``(data, seq,
    model)`` when ``n_model > 1`` (CP x TP: the attention heads and the
    Megatron columns over ``model`` as well; the trunk's heads must divide
    by it, and Ulysses needs ``(heads / n_model) % n_seq == 0``). A model
    parallelized over it (``parallel.sharding.parallelize_model``, which
    takes the arm preference as ``cp_mode``) splits each crop's tokens over
    ``seq`` through its trunk and pixel decoder."""
    if n_model > 1:
        return _device_mesh((n_data, n_seq, n_model), (DATA_AXIS, SEQ_AXIS, MODEL_AXIS), device)
    return _device_mesh((n_data, n_seq), (DATA_AXIS, SEQ_AXIS), device)


def make_pp_mesh(n_pipe: int, n_data: int = 1, device="cuda"):
    """A ``(data, pipe)`` DeviceMesh: the batch over ``data``, the block
    stacks' depth over ``pipe`` (``parallel/pipeline.py``)."""
    return _device_mesh((n_data, n_pipe), (DATA_AXIS, PIPE_AXIS), device)


def make_pipeline_mesh(n_stages: Optional[int] = None, device="cuda"):
    """A 1-D ``(pipe,)`` DeviceMesh of ``n_stages`` ranks (default: every
    rank)."""
    if n_stages is None:
        n_stages = dist.get_world_size() if dist.is_initialized() else 1
    return _device_mesh((n_stages,), (PIPE_AXIS,), device)


def data_mesh_from_env(device="cuda"):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): the process group started
    (``multihost.init_distributed``) and a mesh with every rank on the data
    axis, the JAX CLIs' ``make_mesh()`` over all devices; None otherwise."""
    import os

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    from vtp_tpu_torch.parallel.multihost import init_distributed

    init_distributed(device)
    return make_mesh(device=device)


def check_mesh(mesh, what: str) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a DeviceMesh with a data axis
    (the port's counterpart of the JAX package's mesh and shardings)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or DATA_AXIS not in (mesh.mesh_dim_names or ()):
        raise TypeError(f"{what} takes a DeviceMesh with a {DATA_AXIS!r} axis "
                        f"(parallel.mesh.make_mesh), not {type(mesh).__name__}")


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis as a collective sees it."""

    name: str
    group: Any
    size: int
    rank: int

    def __deepcopy__(self, memo):  # a process group is shared, never copied
        return self


def axis_group(mesh, axis: str) -> Optional[AxisGroup]:
    """``axis`` of ``mesh`` (None without a mesh or without that axis). A
    size-1 axis is returned too: its collectives run."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return AxisGroup(axis, mesh.get_group(axis), mesh_axis_size(mesh, axis),
                     mesh.get_local_rank(axis))
