"""Parallelism of the port on ``torch.distributed`` (port of
``vtp_tpu/parallel``: ``multihost.py``, ``mesh.py``, ``sharding.py``,
``fsdp.py``, ``pipeline.py``): one process a GPU under ``torchrun``, an
explicit DeviceMesh over ``data`` with ``model`` (tensor and sequence
parallelism: Megatron collectives as autograd functions, rank-local weight
slabs), ``seq`` (context parallelism: the ring and Ulysses attention of
``ops/ring_attention.py``, CP x TP beside ``model``) or ``pipe`` (GPipe over
the block stacks), and ZeRO-3 FSDP over ``data`` (beside ``model`` too)."""

from vtp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    make_cp_mesh,
    make_mesh,
    make_pipeline_mesh,
    make_pp_mesh,
    mesh_axis_size,
)
from vtp_tpu_torch.parallel.multihost import host_shard_info, init_distributed, is_main_process
from vtp_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_blocks
from vtp_tpu_torch.parallel.sharding import (
    gather_state_dict,
    param_partition_specs,
    parallelize_model,
    shard_batch,
    shard_state_dict,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "make_mesh", "make_cp_mesh",
           "make_pp_mesh", "make_pipeline_mesh", "mesh_axis_size", "init_distributed",
           "host_shard_info", "is_main_process", "param_partition_specs", "parallelize_model",
           "shard_batch", "shard_state_dict", "gather_state_dict", "pipeline_apply",
           "pipeline_blocks"]
