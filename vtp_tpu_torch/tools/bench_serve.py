"""Mixed-load benchmark of the port's ``VTPServer`` (port of
``tools/bench_serve.py``): concurrent encode / decode / clip_image /
clip_text clients against one server, per-kind p50/p99 request latency and
the aggregate rows/s.

Each client thread submits fixed-size requests back to back (closed loop);
a request's latency is submit -> ``future.result()``: queueing, batch
coalescing (``max_wait_ms``), the device's work and the copy to the host.
The model is ``VTPModel.init`` of the preset with seeded random weights
(bf16 encode, exact fp32 decode). Before the run it times host <-> device
copies of one batch of images (``torch`` copies), the floor under any
image request's latency.

    python -m vtp_tpu_torch.tools.bench_serve [--preset vtp-large] [--seconds 45]
        [--rows 8] [--batch_size 32] [--clients encode,decode,clip_image] [--device cpu]

Prints one JSON line, the JAX CLI's: ``metric``, ``value`` (aggregate
rows/s), ``unit``, ``vs_baseline``, ``kinds`` and
``host_device_transfer_floor``. It is a CLI for serving experiments, not
the port's benchmark.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="vtp-large")
    p.add_argument("--seconds", type=float, default=45.0)
    p.add_argument("--rows", type=int, default=8, help="rows per request")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--clients", default="encode,decode,clip_image",
                   help="comma list of request kinds, one client thread each")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def transfer_floor(shape, device: str, n_probe: int = 3) -> dict:
    """Mean time of a host -> device -> host round trip of an fp32 tensor of
    ``shape`` (``.cpu()`` waits for the copy)."""
    import torch

    probe = torch.zeros(shape, dtype=torch.float32)
    t0 = time.perf_counter()
    for _ in range(n_probe):
        probe.to(device).cpu()
    rt = (time.perf_counter() - t0) / n_probe
    mb = probe.numel() * probe.element_size() / 1e6
    return {"mb_each_way": round(mb, 1), "roundtrip_ms": round(rt * 1e3, 1),
            "mb_per_sec": round(2 * mb / rt, 1)}


def main(argv: Optional[List[str]] = None) -> dict:
    """Runs the benchmark, prints its JSON line and returns it as a dict."""
    args = parse_args(argv)

    import torch

    from vtp_tpu_torch.config import PRESETS
    from vtp_tpu_torch.models.vtp_model import VTPModel
    from vtp_tpu_torch.serve import VTPServer

    cfg = PRESETS[args.preset]()
    model = VTPModel.init(cfg, torch.Generator(device=args.device).manual_seed(0),
                          device=args.device)
    s = cfg.image_size
    g = s // cfg.vision_patch_size
    rng = np.random.default_rng(0)
    payloads = {
        "encode": rng.standard_normal((args.rows, 3, s, s)).astype(np.float32),
        "decode": rng.standard_normal(
            (args.rows, cfg.vision_feature_bottleneck, g, g)).astype(np.float32),
        "clip_image": rng.standard_normal((args.rows, 3, s, s)).astype(np.float32),
        "clip_text": rng.integers(
            1, cfg.text_vocab_size - 2, (args.rows, cfg.text_context_length)).astype(np.int64),
    }
    kinds = [k.strip() for k in args.clients.split(",") if k.strip()]
    for k in kinds:
        if k not in payloads:
            raise SystemExit(f"unknown client kind {k}")

    transfer = transfer_floor((args.batch_size, 3, s, s), args.device)
    print(f"[serve-bench] transfer floor: {transfer['mb_each_way']:.0f} MB up+down in "
          f"{transfer['roundtrip_ms']:.1f} ms ({transfer['mb_per_sec']:.0f} MB/s)",
          file=sys.stderr)

    server = VTPServer(model, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms)
    try:
        for k in kinds:  # each kind's first call outside the measured window
            server.submit(k, payloads[k]).result()

        stop = threading.Event()
        lat = {k: [] for k in kinds}
        done_rows = {k: 0 for k in kinds}

        def client(kind: str) -> None:
            while not stop.is_set():
                t0 = time.perf_counter()
                server.submit(kind, payloads[kind]).result()
                lat[kind].append(time.perf_counter() - t0)
                done_rows[kind] += args.rows

        threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in kinds]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(args.seconds)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        elapsed = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client did not finish its last request within 60 s")
    finally:
        server.shutdown()

    stats = {}
    total_rows = 0
    for k in kinds:
        arr = np.sort(np.array(lat[k]))
        if len(arr) == 0:
            continue
        stats[k] = {
            "requests": int(len(arr)),
            "p50_ms": round(float(np.quantile(arr, 0.5)) * 1e3, 1),
            "p99_ms": round(float(np.quantile(arr, 0.99)) * 1e3, 1),
            "rows_per_sec": round(done_rows[k] / elapsed, 1),
        }
        total_rows += done_rows[k]
        print(f"[serve-bench] {k:11s} n={len(arr):5d} p50={stats[k]['p50_ms']:7.1f}ms "
              f"p99={stats[k]['p99_ms']:7.1f}ms {stats[k]['rows_per_sec']:7.1f} rows/s",
              file=sys.stderr)

    result = {
        "metric": (f"{args.preset} VTPServer mixed-load ({'+'.join(kinds)}, {args.rows}-row "
                   f"requests, batch {args.batch_size}): aggregate rows/sec; per-kind p50/p99 "
                   f"in 'kinds'"),
        "value": round(total_rows / elapsed, 1),
        "unit": "rows/sec/chip",
        "vs_baseline": None,
        "kinds": stats,
        "host_device_transfer_floor": transfer,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
