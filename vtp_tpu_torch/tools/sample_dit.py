"""Sample images from a trained DiT (port of ``tools/sample_dit.py``; the
reference's ``generation/tools/inference_lightningdit_vtp.py``): euler 250
steps, timestep shift 0.075, the no-cfg headline protocol by default; the
samples are de-normalised with the latent statistics, decoded through the
VTP tokenizer and saved as PNGs, plus, with ``--save_npz``, one
``samples.npz`` stack (``arr_0``, (n, H, W, 3) uint8, the ADM FID
evaluation format).

The train state restores into a template (``checkpoint.restore_train_state``)
and the EMA weights sample; the Adam moments are not used, so a state
written with either ``--moment_dtype`` restores. The flags are the JAX
CLI's, plus ``--device``; ``--int8`` samples with the EMA DiT's linears in
int8 W8A8 (``utils.quantization.quantize_matmul_params``), all but the
patchifier ``x_embed`` and the zero-init-sensitive ``final`` head, as the
JAX CLI does (the class table ``y_embed`` is an embedding and stays).
Batch i draws its labels from
``np.random.default_rng(seed)`` and its noise from a ``torch.Generator``
seeded from (seed, images done).

    python -m vtp_tpu_torch.tools.sample_dit --dit_ckpt ./dit_ckpt \\
        --model_path /path/to/vtp-l-hf --latent_dir ./latents_out/latents/... [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


def sample_batches(ema, tokenizer, latent_stats, *, num_samples: int, batch_size: int,
                   num_steps: int = 250, timestep_shift: float = 0.075, cfg_scale: float = 1.0,
                   seed: int = 0) -> Iterator[Tuple["torch.Tensor", "torch.Tensor"]]:
    """Yields ``(latents, images)`` per batch until ``num_samples``: the
    de-normalised (b, C, h, w) fp32 latents and the (b, H, W, 3) uint8
    images on the model's device. Each batch samples ``batch_size`` labels
    and keeps the first b (the last batch may be short)."""
    import torch

    from vtp_tpu_torch.dit.sample import make_sampler
    from vtp_tpu_torch.tools.train_dit import step_generator

    cfg = ema.config
    device = next(ema.parameters()).device
    mean, std = (torch.as_tensor(s, dtype=torch.float32, device=device) for s in latent_stats)
    sampler = make_sampler(cfg, num_steps=num_steps, timestep_shift=timestep_shift,
                           cfg_scale=cfg_scale)
    rng = np.random.default_rng(seed)
    done = 0
    while done < num_samples:
        b = min(batch_size, num_samples - done)
        labels = torch.as_tensor(rng.integers(0, cfg.num_classes, batch_size), device=device)
        z = sampler(ema, labels, step_generator(seed, done, device))[:b]
        z = z * std + mean
        yield z, tokenizer.decode_to_images(z)
        done += b


def quantize_dit_for_serving(ema):
    """The DiT with its linears in int8 W8A8 except the patchifier
    ``x_embed`` and the ``final`` head (``tools/sample_dit.py:68-75``)."""
    from vtp_tpu_torch.utils.quantization import quantize_matmul_params

    return quantize_matmul_params(ema, exclude=lambda name: name in ("x_embed", "final"))


def main(argv: Optional[List[str]] = None) -> Optional[np.ndarray]:
    """Runs the sampling; returns the (n, H, W, 3) uint8 stack with
    ``--save_npz``, else None."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dit_ckpt", required=True, help="dir from tools/train_dit.py")
    p.add_argument("--model_path", required=True, help="VTP checkpoint for decoding")
    p.add_argument("--latent_dir", required=True, help="for latent stats")
    p.add_argument("--preset", default="DiT-XL/1")
    p.add_argument("--in_channels", type=int, default=64)
    p.add_argument("--input_size", type=int, default=16)
    p.add_argument("--depth", type=int, default=None,
                   help="override the preset's depth (debug/tiny runs)")
    p.add_argument("--dim", type=int, default=None,
                   help="override the preset's width (debug/tiny runs)")
    p.add_argument("--num_samples", type=int, default=50_000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_steps", type=int, default=250)
    p.add_argument("--timestep_shift", type=float, default=0.075)
    p.add_argument("--cfg_scale", type=float, default=1.0)
    p.add_argument("--out", default="./dit_samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_npz", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="int8 W8A8 DiT linears (all but x_embed and final)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from vtp_tpu_torch.checkpoint import restore_train_state
    from vtp_tpu_torch.dit.model import make_dit_config
    from vtp_tpu_torch.dit.train import DiTTrainConfig, init_dit_state
    from vtp_tpu_torch.generation import VTPTokenizer
    from vtp_tpu_torch.generation.latents import load_latent_stats

    overrides = {k: v for k, v in (("depth", args.depth), ("dim", args.dim)) if v}
    cfg = make_dit_config(args.preset, in_channels=args.in_channels,
                          input_size=args.input_size, **overrides)
    template = init_dit_state(cfg, DiTTrainConfig(total_steps=1), device=args.device)
    state = restore_train_state(args.dit_ckpt, template, allow_dtype_mismatch=True)
    ema = state.ema  # sample from the EMA weights
    if args.int8:
        ema = quantize_dit_for_serving(ema)
    tokenizer = VTPTokenizer.from_checkpoint(args.model_path, device=args.device)
    stats = load_latent_stats(args.latent_dir)

    from PIL import Image

    os.makedirs(args.out, exist_ok=True)
    all_images = [] if args.save_npz else None
    done = 0
    for _, images in sample_batches(
            ema, tokenizer, stats, num_samples=args.num_samples,
            batch_size=args.batch_size, num_steps=args.num_steps,
            timestep_shift=args.timestep_shift, cfg_scale=args.cfg_scale, seed=args.seed):
        images = images.cpu().numpy()
        for i, img in enumerate(images):
            Image.fromarray(img).save(os.path.join(args.out, f"sample_{done + i:06d}.png"))
        if all_images is not None:
            all_images.append(images)
        done += images.shape[0]
        print(f"{done}/{args.num_samples}", flush=True)

    if all_images is None:
        return None
    arr = np.concatenate(all_images, axis=0)
    np.savez(os.path.join(args.out, "samples.npz"), arr_0=arr)
    print(f"saved {arr.shape} to samples.npz")
    return arr


if __name__ == "__main__":
    main()
