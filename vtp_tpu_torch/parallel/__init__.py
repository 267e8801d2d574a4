"""Data, tensor and sequence parallelism and FSDP of the port, on
``torch.distributed`` (port of ``vtp_tpu/parallel``: ``multihost.py``,
``mesh.py``, ``sharding.py``, ``fsdp.py``): one process a GPU under
``torchrun``, an explicit ``(data, model)`` DeviceMesh, Megatron
collectives as autograd functions, rank-local weight slabs. Context and
pipeline parallelism (``ops/ring_attention.py``, ``parallel/pipeline.py``)
are not ported."""

from vtp_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh, mesh_axis_size
from vtp_tpu_torch.parallel.multihost import host_shard_info, init_distributed, is_main_process
from vtp_tpu_torch.parallel.sharding import (
    gather_state_dict,
    param_partition_specs,
    parallelize_model,
    shard_batch,
    shard_state_dict,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "make_mesh", "mesh_axis_size", "init_distributed",
           "host_shard_info", "is_main_process", "param_partition_specs", "parallelize_model",
           "shard_batch", "shard_state_dict", "gather_state_dict"]
