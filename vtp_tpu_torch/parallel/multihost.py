"""Process-group start-up (port of ``vtp_tpu/parallel/multihost.py``).

The JAX package starts one process a host and lets ``jax.distributed``
wire them; here there is one process a GPU, launched by ``torchrun``,
which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``. ``init_distributed`` reads them (or takes them as
arguments), binds the process to its card and starts the default process
group: NCCL on the card, gloo only for ``device="cpu"`` or when the caller
names it. A failed start raises; nothing falls back to another backend or
to one process.

    torchrun --nproc_per_node 4 -m vtp_tpu_torch.tools.train_vtp --mesh 2,2 ...
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def init_distributed(device="cuda", *, backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: Optional[datetime.timedelta] = None) -> Tuple[int, int]:
    """Start the default process group and return ``(rank, world_size)``.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``), or pass ``file://...`` or ``tcp://host:port``. On
    ``device="cuda"`` the process takes card ``LOCAL_RANK`` and the backend
    is NCCL; on the CPU it is gloo. ``backend`` overrides that choice (gloo
    on a card, for ranks that share one). A group that is already up is
    kept as it is."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = torch.device(device)
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kwargs)
    return rank, world_size


def host_shard_info() -> Tuple[int, int]:
    """(this process's rank, number of processes), for sharded ingest;
    ``(0, 1)`` without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main_process() -> bool:
    return host_shard_info()[0] == 0
