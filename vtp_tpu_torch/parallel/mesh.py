"""The ``(data, model)`` device mesh (port of ``vtp_tpu/parallel/mesh.py``
:17-101: ``DATA_AXIS``, ``MODEL_AXIS``, ``mesh_axis_size``, ``make_mesh``).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank
of the default process group, laid out as JAX's ``make_mesh`` lays out its
devices: rank ``i`` sits at ``(i // n_model, i % n_model)``, so the ranks
of one model group are consecutive. It is always passed explicitly; the
JAX package's ambient mesh (``jax.set_mesh``, ``active_mesh``) has no
counterpart. ``AxisGroup`` is what a collective needs of one axis: its
process group, its size and this rank's place on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (1 when absent or mesh is None)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device="cuda"):
    """A ``(data, model)`` DeviceMesh over the default process group's
    ranks (``parallel.multihost.init_distributed`` first). ``n_data``
    defaults to every rank over ``n_model``. Raises ``ValueError`` when
    ``n_data * n_model`` is not the world size (one process without a
    group is a world of 1)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.init_distributed first")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


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
