"""Bulk latent extraction for DiT training (port of
``tools/extract_latents.py``; the reference's
``generation/tools/extract_features_vtp.py``): encodes the dataset twice,
unflipped and flipped, writes shards of ``--shard_size`` images holding
{latents, latents_flip, labels}, then the per-channel latent statistics.

One GPU a process. Under ``torchrun`` each rank takes its ``ShardedSampler``
slice (``--shard`` / ``--num_shards`` become the rank and the world size)
and writes its own ``latents_rank{r}_shard{s}`` files; rank 0 writes the
statistics after every rank is done. Without ``torchrun`` a multi-process
run passes ``--shard``/``--num_shards`` to each process, and shard 0 writes
the statistics over the shards present when it ends.

    python -m vtp_tpu_torch.tools.extract_latents --model_path /path/to/vtp-l-hf \\
        --data_path /path/to/imagenet/train --output_dir ./latents_out [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np


def extract_latent_shards(tokenizer, batches: Iterable[Tuple[object, object, object]],
                          output_dir: str, *, rank: int = 0, shard_size: int = 10000,
                          total: Optional[int] = None, log_every: int = 10) -> List[str]:
    """Encode ``(images, flipped images, labels)`` batches (normalised
    (B, 3, H, W) arrays or tensors, labels (B,)) with ``tokenizer`` and write
    a shard each time ``shard_size`` rows have gathered, then the rest.
    Returns the shard paths in order."""
    from vtp_tpu_torch.generation.latents import save_latent_shard

    latents, latents_flip, labels, paths = [], [], [], []
    done, t0 = 0, time.time()

    def flush() -> None:
        paths.append(save_latent_shard(output_dir, rank, len(paths), np.concatenate(latents),
                                       np.concatenate(latents_flip), np.concatenate(labels)))
        print(f"Saved shard {len(paths) - 1}", flush=True)
        for buf in (latents, latents_flip, labels):
            buf.clear()

    for i, (x0, x1, y) in enumerate(batches):
        latents.append(tokenizer.encode_images(x0).cpu().numpy())
        latents_flip.append(tokenizer.encode_images(x1).cpu().numpy())
        labels.append(np.asarray(y.cpu() if hasattr(y, "cpu") else y))
        done += latents[-1].shape[0]
        if log_every and (i + 1) % log_every == 0:
            rate = done / (time.time() - t0)
            print(f"{done}/{total or '?'} images ({rate:.1f} img/s incl. flip)", flush=True)
        if sum(z.shape[0] for z in latents) >= shard_size:
            flush()
    if latents:
        flush()
    return paths


def main(argv: Optional[List[str]] = None) -> str:
    """Runs the extraction and returns the output directory."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", required=True)
    p.add_argument("--data_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--normalize_type", default="imagenet", choices=["imagenet", "half"])
    p.add_argument("--shard", type=int, default=0, help="process shard index")
    p.add_argument("--num_shards", type=int, default=1, help="number of processes")
    p.add_argument("--shard_size", type=int, default=10000)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--int8", action="store_true",
                   help="encode with the int8 W8A8 trunk (VTPTokenizer(quantize_int8=True))")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from vtp_tpu_torch.data import DataLoader, ImageFolder, ShardedSampler
    from vtp_tpu_torch.generation import VTPTokenizer, compute_latent_stats
    from vtp_tpu_torch.parallel.mesh import data_mesh_from_env

    mesh = data_mesh_from_env(args.device)
    if mesh is not None:
        import torch.distributed as dist

        args.shard, args.num_shards = dist.get_rank(), dist.get_world_size()

    tokenizer = VTPTokenizer.from_checkpoint(
        args.model_path, device=args.device, img_size=args.image_size,
        normalize_type=args.normalize_type, quantize_int8=args.int8)
    model_name = os.path.basename(args.model_path.rstrip("/"))
    output_dir = os.path.join(args.output_dir, "latents", model_name,
                              f"imgnet{args.image_size}_norm{args.normalize_type}")
    os.makedirs(output_dir, exist_ok=True)
    print(f"Output directory: {output_dir}")

    datasets = [ImageFolder(args.data_path, transform=tokenizer.img_transform(p_hflip=flip))
                for flip in (0.0, 1.0)]
    n = len(datasets[0])
    if args.max_samples:
        n = min(n, args.max_samples)
    sampler = ShardedSampler(n, args.shard, args.num_shards).indices()
    loaders = [DataLoader(ds, args.batch_size, sampler=sampler, num_workers=args.num_workers)
               for ds in datasets]
    print(f"Total data: {len(datasets[0])}, this shard: {len(sampler)}")
    batches = ((x0, x1, y0) for (x0, y0), (x1, _) in zip(*loaders))
    extract_latent_shards(tokenizer, batches, output_dir, rank=args.shard,
                          shard_size=args.shard_size, total=len(sampler))

    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    if args.shard == 0:
        mean, _ = compute_latent_stats(output_dir)
        print(f"Latent stats saved to {output_dir} "
              f"(mean range [{mean.min():.3f}, {mean.max():.3f}])")
    return output_dir


if __name__ == "__main__":
    main()
