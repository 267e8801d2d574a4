"""Run a function on several CPU ranks over gloo, for the port's parallel
tests. Imports no JAX: the spawned children import this module and the
worker functions' module (``tests/torch_parallel_workers.py``), never
JAX or ``vtp_tpu``.

    results = run_ranks(fn, 4, tmp_path, arg1, arg2)   # [rank 0's return, ...]
    join = start_ranks(fn, 4, tmp_path, arg1, arg2)    # ... work meanwhile ...; join()

Each child rendezvouses through a file under ``tmp_path`` (no port, so
parallel pytest workers never race for one), runs with one thread
(``OMP_NUM_THREADS=1``, ``torch.set_num_threads(1)``), starts a gloo group
with a timeout, calls ``fn(rank, world_size, *args)`` and saves its return
value with ``torch.save``. The parent joins the children against a
deadline, kills them if it passes, and raises a failing rank's traceback.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Callable, List

import torch
import torch.multiprocessing as mp

GLOO_TIMEOUT_S = 120


def _child(rank: int, fn: Callable, world_size: int, root: str, args: tuple) -> None:
    torch.set_num_threads(1)
    from vtp_tpu_torch.parallel.multihost import init_distributed

    init_distributed("cpu", init_method=f"file://{os.path.join(root, 'rendezvous')}",
                     rank=rank, world_size=world_size,
                     timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    try:
        out = fn(rank, world_size, *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, tmp_path, *args: Any,
              timeout: float = 300.0) -> List[Any]:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks; the
    ranks' return values in rank order."""
    return start_ranks(fn, world_size, tmp_path, *args, timeout=timeout)()


def start_ranks(fn: Callable, world_size: int, tmp_path, *args: Any,
                timeout: float = 300.0) -> Callable[[], List[Any]]:
    """``run_ranks`` without the wait: the ranks start and the returned
    function joins them (against the deadline ``timeout`` seconds from now)
    and returns their values, so the caller can work meanwhile."""
    root = os.path.join(str(tmp_path), f"ranks_{fn.__name__}_{time.monotonic_ns()}")
    os.makedirs(root)
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        ctx = mp.start_processes(_child, args=(fn, world_size, root, args), nprocs=world_size,
                                 join=False, start_method="spawn")
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    deadline = time.monotonic() + timeout

    def join() -> List[Any]:
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{fn.__name__} on {world_size} ranks ran past "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]

    return join
