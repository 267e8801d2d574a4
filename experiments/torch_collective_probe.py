"""Which point-to-point collectives gloo and NCCL carry on CUDA tensors.

    python3 experiments/torch_collective_probe.py

Two spawned ranks share card 0 over gloo and try, each op in a spawn of its
own (a backend that reads a device pointer from the host may crash the
rank): a cyclic shift by ``all_to_all_single`` with per-peer split sizes
(the port's ``ppermute``), an equal-split ``all_to_all_single`` (Ulysses'),
``batch_isend_irecv`` and, for reference, ``all_reduce`` and
``all_gather_into_tensor``. Then one NCCL rank (two NCCL ranks cannot share
a device) tries the same ``all_to_all_single`` forms. Prints one line an op:
ok, wrong, raised or crashed.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_to_all_shift", "all_to_all_equal", "all_reduce", "all_gather", "batch_isend_irecv")


def _run(op: str, rank: int, world: int) -> bool:
    dev = torch.device("cuda", 0)
    x = torch.arange(6, dtype=torch.float32, device=dev) + 100 * rank
    if op == "all_to_all_shift":
        dst, src = (rank + 1) % world, (rank - 1) % world
        out = torch.empty_like(x)
        ins = [x.numel() if r == dst else 0 for r in range(world)]
        outs = [x.numel() if r == src else 0 for r in range(world)]
        dist.all_to_all_single(out, x, outs, ins)
        want = torch.arange(6, dtype=torch.float32, device=dev) + 100 * src
    elif op == "all_to_all_equal":
        x = torch.arange(2 * world, dtype=torch.float32, device=dev) + 100 * rank
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        want = torch.cat([torch.arange(2 * rank, 2 * rank + 2, dtype=torch.float32, device=dev)
                          + 100 * r for r in range(world)])
    elif op == "all_reduce":
        out = x.clone()
        dist.all_reduce(out)
        want = sum(torch.arange(6, dtype=torch.float32, device=dev) + 100 * r
                   for r in range(world))
    elif op == "all_gather":
        out = x.new_empty(world * 6)
        dist.all_gather_into_tensor(out, x)
        want = torch.cat([torch.arange(6, dtype=torch.float32, device=dev) + 100 * r
                          for r in range(world)])
    else:
        dst, src = (rank + 1) % world, (rank - 1) % world
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, dst), dist.P2POp(dist.irecv, out, src)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        want = torch.arange(6, dtype=torch.float32, device=dev) + 100 * src
    torch.cuda.synchronize()
    return bool(torch.equal(out, want))


def _rank(rank: int, op: str, world: int, backend: str, root: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{root}/store_{backend}_{op}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        try:
            res = "ok" if _run(op, rank, world) else "wrong"
        except Exception as e:  # the probe's answer is the exception itself
            res = f"raised {type(e).__name__}: {str(e).splitlines()[0][:160]}"
        with open(os.path.join(root, f"{backend}_{op}_{rank}"), "w") as f:
            f.write(res)
    finally:
        dist.destroy_process_group()


def probe(backend: str, world: int, ops, root: str) -> None:
    for op in ops:
        ctx = mp.start_processes(_rank, args=(op, world, backend, root), nprocs=world,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=120):
                pass
            outcome = None
        except Exception as e:  # a crashed rank: ProcessExitedException and kin
            outcome = f"crashed ({type(e).__name__}: {str(e).splitlines()[0][:120]})"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        if outcome is None:
            res = []
            for r in range(world):
                path = os.path.join(root, f"{backend}_{op}_{r}")
                res.append(open(path).read() if os.path.exists(path) else "no result")
            outcome = "; ".join(sorted(set(res)))
        print(f"{backend} world {world} {op} on CUDA tensors: {outcome}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    with tempfile.TemporaryDirectory(prefix="probe_") as root:
        probe("gloo", 2, OPS, root)
        probe("nccl", 1, ("all_to_all_shift", "all_to_all_equal"), root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
