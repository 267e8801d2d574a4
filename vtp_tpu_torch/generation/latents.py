"""Latent shard IO and statistics for DiT training (port of
``vtp_tpu/generation/latents.py:23-119``).

A shard is ``latents_rank{r:02d}_shard{s:03d}.safetensors`` holding
{latents, latents_flip, labels} with the metadata ``total_size`` (rows)
and ``dtype`` (the latents' numpy dtype), the layout of the reference's
``generation/tools/extract_features_vtp.py``. The statistics are the
per-channel mean and std, (1, d, 1, 1) fp32, over every shard and both
flip variants, streamed in float64 numpy as the JAX package does, so both
packages give the same bits from the same shards. They are written as
``latents_stats.safetensors`` and, for LightningDiT, as the torch-pickled
``latents_stats.pt``. Files go through the port's own ``.safetensors``
reader and writer (``convert/safetensors_io.py``); either package reads
the other's shards.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from vtp_tpu_torch.convert.safetensors_io import load_safetensors, save_safetensors

STATS_FILE = "latents_stats.safetensors"
STATS_PT_FILE = "latents_stats.pt"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def shard_name(rank: int, shard_idx: int) -> str:
    return f"latents_rank{rank:02d}_shard{shard_idx:03d}.safetensors"


def save_latent_shard(output_dir: str, rank: int, shard_idx: int, latents, latents_flip,
                      labels) -> str:
    """Write one shard (arrays or tensors on any device) and return its path."""
    latents, latents_flip, labels = (_host(x) for x in (latents, latents_flip, labels))
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, shard_name(rank, shard_idx))
    save_safetensors(path, {"latents": latents, "latents_flip": latents_flip, "labels": labels},
                     metadata={"total_size": str(latents.shape[0]), "dtype": str(latents.dtype)})
    return path


def list_latent_shards(output_dir: str) -> List[str]:
    pat = re.compile(r"latents_rank\d+_shard\d+\.safetensors$")
    return sorted(os.path.join(output_dir, f) for f in os.listdir(output_dir) if pat.match(f))


def load_latent_shards(output_dir: str) -> Iterator[Dict[str, np.ndarray]]:
    for path in list_latent_shards(output_dir):
        yield load_safetensors(path)


def compute_latent_stats(output_dir: str, save: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean and std (1, d, 1, 1) fp32 over all shards (both flip
    variants), streamed one shard at a time."""
    total = total_sq = None
    count = 0
    for shard in load_latent_shards(output_dir):
        for key in ("latents", "latents_flip"):
            z = shard[key].astype(np.float64)  # (N, d, h, w)
            s = z.sum(axis=(0, 2, 3))
            sq = (z * z).sum(axis=(0, 2, 3))
            n = z.shape[0] * z.shape[2] * z.shape[3]
            total = s if total is None else total + s
            total_sq = sq if total_sq is None else total_sq + sq
            count += n
    if total is None:
        raise FileNotFoundError(f"no latent shards in {output_dir}")
    mean = (total / count).astype(np.float32).reshape(1, -1, 1, 1)
    var = total_sq / count - (total / count) ** 2
    std = np.sqrt(np.maximum(var, 0)).astype(np.float32).reshape(1, -1, 1, 1)
    if save:
        save_latent_stats(output_dir, mean, std)
    return mean, std


def save_latent_stats(output_dir: str, mean: np.ndarray, std: np.ndarray) -> None:
    save_safetensors(os.path.join(output_dir, STATS_FILE), {"mean": mean, "std": std})
    torch.save({"mean": torch.from_numpy(mean), "std": torch.from_numpy(std)},
               os.path.join(output_dir, STATS_PT_FILE))


def load_latent_stats(output_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) as numpy, from the ``.safetensors`` file or else the ``.pt``."""
    st = os.path.join(output_dir, STATS_FILE)
    if os.path.exists(st):
        d = load_safetensors(st)
        return d["mean"], d["std"]
    pt = os.path.join(output_dir, STATS_PT_FILE)
    if os.path.exists(pt):
        d = torch.load(pt, map_location="cpu", weights_only=True)
        return d["mean"].numpy(), d["std"].numpy()
    raise FileNotFoundError(f"no latent stats in {output_dir}")
