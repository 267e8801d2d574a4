"""Train a latent DiT on extracted VTP latents (port of
``tools/train_dit.py``; the reference's LightningDiT recipe: DiT-XL/1 on
f16d64 latents, AdamW 2e-4 beta2 0.95, global batch 1024,
velocity/Linear transport with the cosine loss and lognorm time sampling,
EMA, latents normalised by the extracted statistics).

The flags and defaults are the JAX CLI's (``--remat attn`` included), plus
``--device``. ``--no_unroll_layers`` is accepted and changes nothing (the
depth loop is a Python loop). Each step draws from a ``torch.Generator``
seeded from ``(seed, step)``, so a resumed run draws what an uninterrupted
one would. Checkpoints are train states (``checkpoint.save_train_state``,
written on a background thread) under ``--out``; ``--resume`` continues
from the latest, and, unlike the JAX CLI, which restarts the data stream,
skips the batches the saved steps took (``LatentShardDataset.batches``'
``skip``), so a resumed step equals the uninterrupted run's.

Under ``torchrun`` the step is data-parallel over every rank (the JAX CLI's
mesh over all devices, :118-145): a replicated state, each rank reading the
same global batch and running its rows, the gradients summed in one
collective; rank 0 logs and writes the checkpoints.

    python -m vtp_tpu_torch.tools.train_dit --latent_dir ./latents_out/latents/vtp-l/... \\
        --preset DiT-XL/1 --batch_size 1024 --steps 100000 --out ./dit_ckpt [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional


def step_generator(seed: int, step: int, device) -> "torch.Generator":
    """The step's generator, seeded from (seed, step) (the JAX CLI's
    ``fold_in(key(seed), step)``)."""
    import torch

    return torch.Generator(device=device).manual_seed(((seed % 2**31) << 32) + step)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Runs the training and returns ``{"state": the DiTState, "metrics":
    [each step's metrics as floats], "start_step": the first step run}``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--latent_dir", required=True)
    p.add_argument("--preset", default="DiT-XL/1")
    p.add_argument("--in_channels", type=int, default=64)
    p.add_argument("--input_size", type=int, default=16)
    p.add_argument("--depth", type=int, default=None,
                   help="override the preset's depth (debug/tiny runs)")
    p.add_argument("--dim", type=int, default=None,
                   help="override the preset's width (debug/tiny runs)")
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: split the global batch into this many "
                        "microbatches per optimizer step")
    p.add_argument("--accum_dtype", default="fp32", choices=["fp32", "bf16"],
                   help="the gradient accumulators' dtype")
    p.add_argument("--moment_dtype", default="fp32", choices=["fp32", "bf16"],
                   help="Adam moment storage (bf16 halves the optimizer's state)")
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lognorm_mu", type=float, default=-0.75)
    p.add_argument("--lognorm_sigma", type=float, default=1.0)
    p.add_argument("--ckpt_every", type=int, default=20_000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--out", default="./dit_ckpt")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--remat", default="attn", choices=["off", "full", "dots", "attn", "dots_attn"],
                   help="gradient-checkpoint policy (models/blocks.checkpoint_policy)")
    p.add_argument("--no_unroll_layers", action="store_true",
                   help="accepted for the JAX CLI's sake; changes nothing here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from vtp_tpu_torch.checkpoint import (
        latest_train_state_step,
        restore_train_state,
        save_train_state,
        wait_for_checkpoints,
    )
    from vtp_tpu_torch.dit.model import make_dit_config
    from vtp_tpu_torch.dit.train import (
        DiTTrainConfig,
        LatentShardDataset,
        build_dit_train_step,
        init_dit_state,
    )

    overrides = {k: v for k, v in (("depth", args.depth), ("dim", args.dim)) if v}
    cfg = make_dit_config(args.preset, in_channels=args.in_channels,
                          input_size=args.input_size, **overrides)
    tcfg = DiTTrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        lognorm_mu=args.lognorm_mu, lognorm_sigma=args.lognorm_sigma,
        remat=(False if args.remat == "off" else True if args.remat == "full" else args.remat),
        unroll_layers=not args.no_unroll_layers,
        accum_steps=args.accum_steps, accum_dtype=args.accum_dtype,
        moment_dtype=args.moment_dtype,
    )
    from vtp_tpu_torch.parallel.mesh import data_mesh_from_env
    from vtp_tpu_torch.parallel.multihost import host_shard_info

    mesh = data_mesh_from_env(args.device)
    world = host_shard_info()[1]
    if args.batch_size % (args.accum_steps * world):
        raise SystemExit(f"batch_size must divide by accum_steps x ranks "
                         f"({args.accum_steps} x {world})")
    main_rank = host_shard_info()[0] == 0

    state = init_dit_state(cfg, tcfg, torch.Generator(device=args.device).manual_seed(args.seed),
                           device=args.device)
    start_step = 0
    if args.resume and latest_train_state_step(args.out) is not None:
        state = restore_train_state(args.out, state)
        start_step = state.step
        if main_rank:
            print(f"resumed from step {start_step}")
    step_fn = build_dit_train_step(cfg, tcfg, mesh)

    ds = LatentShardDataset(args.latent_dir, latent_norm=True, seed=args.seed,
                            device=args.device)
    # a resumed run continues the data stream where the saved one stopped
    batches = ds.batches(args.batch_size, skip=start_step)

    history = []
    t0 = time.time()
    accum = args.accum_steps
    for step in range(start_step, args.steps):
        z, y = next(batches)
        if accum > 1:  # leading (accum,) microbatch axis
            z = z.reshape(accum, -1, *z.shape[1:])
            y = y.reshape(accum, -1)
        state, metrics = step_fn(state, z, y, step_generator(args.seed, step, args.device))
        history.append(metrics)  # device scalars: read at a log step or at the end
        if main_rank and (step + 1) % args.log_every == 0:
            rate = args.log_every * args.batch_size / (time.time() - t0)
            print(f"step {step + 1}: loss {float(metrics['loss/transport']):.4f} "
                  f"(mse {float(metrics['loss/mse']):.4f}) {rate:.0f} img/s", flush=True)
            t0 = time.time()
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            save_train_state(args.out, state, block=False)
            if main_rank:
                print(f"saved checkpoint at step {step + 1}", flush=True)

    wait_for_checkpoints()
    return {"state": state, "start_step": start_step,
            "metrics": [{k: float(v) for k, v in m.items()} for m in history]}


if __name__ == "__main__":
    main()
