"""VTP pre-training: CLIP + DINO/iBOT SSL + reconstruction (port of
``tools/train_vtp.py``): config -> multi-crop data (``data/ssl_crops.py``)
or synthetic batches -> the train step (``train/step.py``, with
``--accum_steps`` microbatches a step) -> train-state checkpoints.

The flags and defaults are the JAX CLI's, plus ``--device``,
``--total_steps`` (the learning-rate schedule's length, ``--steps`` unless
given, so that a run may stop short of its schedule and be resumed to it)
and the cuts for small runs ``--depth`` (every tower's depth) and
``--dino_out_dim`` / ``--dino_hidden_dim`` / ``--dino_bottleneck_dim``. ``--unroll_layers``,
``--unroll_chunk`` and ``--num_workers`` with ``--synthetic`` change nothing
(the depth loop is a Python loop).

Under ``torchrun`` the run spreads over every rank (NCCL on the card, gloo
with ``--device cpu``): ``--mesh DATA,MODEL`` (default: every rank on the
data axis) with ``--tp_head_major`` (the trunk stored head-major for the
model axis) and ``--sequence_parallel``; ``--context_parallel S`` (a
``(data, seq[, model])`` mesh, ``--cp_mode`` the attention arm; with
``--mesh DATA,MODEL``, CP x TP) and ``--pipeline_parallel P`` (a ``(data,
pipe)`` mesh; a tower whose depth does not divide P runs its sequential
loop), all checked as the JAX CLI checks them (:272-315); ``drop_shards``
is the data axis. Every rank builds the same global batch and takes its
rows; rank 0 logs and writes the checkpoints, which hold the gathered state
in its stored layout.

    torchrun --nproc_per_node 4 -m vtp_tpu_torch.tools.train_vtp --synthetic \
        --mesh 2,2 --tp_head_major --sequence_parallel --steps 20
    torchrun --nproc_per_node 4 -m vtp_tpu_torch.tools.train_vtp --synthetic \
        --context_parallel 2 --cp_mode ring --steps 20        # or --pipeline_parallel 2

CLIP captions are "a photo of a {class}", tokenized once per class; when
the BPE vocab is absent they are deterministic pseudo-captions, as in the
JAX CLI. Each step draws from a ``torch.Generator`` seeded from ``(seed,
step)``, and the synthetic batch of step s from
``numpy.random.default_rng([seed, s])``, so a resumed synthetic run
equals an uninterrupted one (the JAX CLI folds only the start step into
its synthetic stream). The folder path keeps the JAX CLI's stream seeds,
``seed + 7919 * start_step``. Checkpoints are train states
(``checkpoint.save_train_state`` on its writer thread) under ``--out``,
beside ``train_meta.json``, the qkv layout the run was started with;
``--resume`` continues from the latest. ``--export_hf`` writes the student
without the DINO head as an HF-layout checkpoint (``out/hf_export``).

    python -m vtp_tpu_torch.tools.train_vtp --preset vtp-base --data_dir /data/train \\
        --batch_size 256 --steps 100000 --out ./vtp_ckpt
    python -m vtp_tpu_torch.tools.train_vtp --synthetic --steps 20 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

def parse_args(argv=None) -> argparse.Namespace:
    from vtp_tpu_torch.train.step import TrainConfig

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="vtp-base", help="vtp-small / vtp-base / vtp-large")
    p.add_argument("--config", default=None,
                   help="HF config.json or legacy VTP YAML (overrides --preset)")
    p.add_argument("--data_dir", default=None, help="ImageFolder root")
    p.add_argument("--synthetic", action="store_true", help="random data")
    p.add_argument("--objectives", default="clip,ssl,rec")
    p.add_argument("--batch_size", type=int, default=256, help="global batch")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="split the global batch into this many microbatches a step; "
                        "contrastive negatives stay within a microbatch")
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--total_steps", type=int, default=None,
                   help="the learning-rate schedule's length (default: --steps)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.04)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--teacher_momentum", type=float, default=0.994)
    p.add_argument("--local_crops", type=int, default=4)
    p.add_argument("--local_size", type=int, default=96)
    p.add_argument("--mask_ratio", type=float, default=0.3)
    p.add_argument("--compute_dtype", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--moment_dtype", default="fp32", choices=["fp32", "bf16"],
                   help="Adam moment storage (bf16 halves the optimizer's state)")
    p.add_argument("--remat", default="full", choices=["off", "full", "dots", "attn", "dots_attn"],
                   help="gradient-checkpoint policy (models/blocks.checkpoint_policy)")
    p.add_argument("--no_remat", action="store_true", help="deprecated alias for --remat off")
    p.add_argument("--unroll_layers", action="store_true", help="accepted; changes nothing")
    p.add_argument("--unroll_chunk", type=int, default=0, help="accepted; changes nothing")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--sequence_parallel", action="store_true",
                   help="Megatron sequence parallelism over the model axis")
    p.add_argument("--mesh", default=None,
                   help="DATA,MODEL: the (data, model) mesh over the torchrun ranks")
    p.add_argument("--tp_head_major", action="store_true",
                   help="store the trunk's qkv head-major for the model axis")
    p.add_argument("--context_parallel", type=int, default=1,
                   help="split the attention token dim over a seq axis of this size (ring / "
                        "Ulysses context parallelism, ops/ring_attention.py); composes with "
                        "the data axis and a model axis (CP x TP, --mesh DATA,MODEL) when "
                        "vision_num_heads %% model == 0")
    p.add_argument("--cp_mode", default="auto", choices=["auto", "ring", "ulysses"],
                   help="context-parallel arm (auto: Ulysses when a rank's heads divide the "
                        "seq axis, else the ring)")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="stage-shard the block stacks over a pipe axis of this size (GPipe, "
                        "parallel/pipeline.py); composes with the data axis; a tower whose "
                        "depth or microbatch does not divide runs its sequential loop")
    p.add_argument("--out", default="./vtp_ckpt")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--export_hf", action="store_true",
                   help="also write an HF-layout model dir at the end")
    p.add_argument("--allow_pseudo_captions", action="store_true",
                   help="tolerate a tokenizer/vocab mismatch (tiny debug configs) with "
                        "deterministic pseudo-captions instead of raising")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--depth", type=int, default=None,
                   help="cut every tower (vision, text, decoder) to this depth")
    p.add_argument("--dino_out_dim", type=int, default=TrainConfig.dino_out_dim)
    p.add_argument("--dino_hidden_dim", type=int, default=TrainConfig.dino_hidden_dim)
    p.add_argument("--dino_bottleneck_dim", type=int, default=TrainConfig.dino_bottleneck_dim)
    return p.parse_args(argv)


def load_config(args):
    from vtp_tpu_torch.config import PRESETS, VTPConfig

    if args.config:
        if args.config.endswith((".yaml", ".yml")):
            cfg = VTPConfig.from_vtp_yaml(args.config)
        else:
            cfg = VTPConfig.from_hf_json(args.config)
    else:
        cfg = PRESETS[args.preset]()
    if args.depth:
        cfg = cfg.replace(vision_depth=args.depth, text_depth=args.depth,
                          decoder_depth=args.depth)
    return cfg


def _pseudo_captions(n_classes: int, context_length: int, vocab_size: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    toks = rng.integers(1, max(vocab_size - 1, 2), size=(n_classes, context_length))
    return toks.astype(np.int64)


def class_captions(classes: List[str], context_length: int, vocab_size: int,
                   allow_pseudo_captions: bool = False) -> np.ndarray:
    """'a photo of a {c}' tokenized once per class; pseudo-captions only
    when the BPE vocab is absent or ``allow_pseudo_captions`` covers ids
    beyond ``vocab_size`` (a tiny debug vocab); otherwise such ids raise."""
    try:
        from vtp_tpu_torch.tokenizers import get_tokenizer

        tok = get_tokenizer(context_length=context_length)
    except (FileNotFoundError, OSError, ImportError) as e:
        print(f"[train_vtp] BPE vocab unavailable ({e}); using pseudo-captions")
        return _pseudo_captions(len(classes), context_length, vocab_size)
    toks = np.asarray(tok([f"a photo of a {c.replace('_', ' ')}" for c in classes]))
    if toks.max() >= vocab_size:
        if allow_pseudo_captions:
            print(f"[train_vtp] BPE ids exceed text_vocab_size={vocab_size}; "
                  "--allow_pseudo_captions set, using pseudo-captions")
            return _pseudo_captions(len(classes), context_length, vocab_size)
        raise ValueError(f"BPE token ids (max {toks.max()}) exceed text_vocab_size={vocab_size}"
                         " (pass --allow_pseudo_captions for debug configs)")
    return toks


def synthetic_microbatch(rng: np.random.Generator, args, cfg, n_patches: int, b: int) -> Dict:
    """One microbatch of ``b`` images, drawn in the JAX CLI's order."""
    from vtp_tpu_torch.data.ssl_crops import make_mask_bookkeeping

    S, L = cfg.image_size, args.local_size
    ssl = make_mask_bookkeeping(rng, 2 * b, n_patches, args.mask_ratio)
    ssl["global_crops"] = rng.standard_normal((2 * b, 3, S, S), np.float32)
    ssl["local_crops"] = rng.standard_normal((args.local_crops * b, 3, L, L), np.float32)
    return {"image": ssl["global_crops"][:b],
            "text": rng.integers(1, cfg.text_vocab_size - 1, (b, cfg.text_context_length)),
            "rec_image": ssl["global_crops"][:b], "ssl": ssl}


def synthetic_batches(args, cfg, n_patches: int, start_step: int = 0) -> Iterator[List[Dict]]:
    """Each step's ``accum_steps`` microbatches, from ``default_rng([seed, step])``."""
    b = args.batch_size // args.accum_steps
    for step in range(start_step, args.steps):
        rng = np.random.default_rng([args.seed, step])
        yield [synthetic_microbatch(rng, args, cfg, n_patches, b)
               for _ in range(args.accum_steps)]


def folder_batches(args, cfg, n_patches: int, start_step: int = 0) -> Iterator[List[Dict]]:
    """Each step's ``accum_steps`` microbatches of multi-crop views of the
    image folder, with the JAX CLI's stream seeds."""
    from vtp_tpu_torch.data import (
        DataLoader,
        ImageFolder,
        InfiniteSampler,
        MultiCropDataset,
        MultiCropTransform,
        collate_multicrop,
        make_mask_bookkeeping,
    )

    folder = ImageFolder(args.data_dir)
    captions = class_captions(folder.classes, cfg.text_context_length, cfg.text_vocab_size,
                              allow_pseudo_captions=args.allow_pseudo_captions)
    transform = MultiCropTransform(global_size=cfg.image_size, local_size=args.local_size,
                                   n_local=args.local_crops)
    # a resumed run continues on fresh samples, crops and masks
    seed = args.seed + 7919 * start_step
    ds = MultiCropDataset(folder, transform, seed=seed)
    loader = DataLoader(ds, args.batch_size // args.accum_steps,
                        sampler=InfiniteSampler(len(ds), seed=seed),
                        num_workers=args.num_workers, drop_last=True, collate=collate_multicrop)
    rng = np.random.default_rng([args.seed + 1, start_step])
    micros = []
    for global_crops, local_crops, labels in loader:
        b = labels.shape[0]
        ssl = make_mask_bookkeeping(rng, 2 * b, n_patches, args.mask_ratio)
        ssl["global_crops"] = global_crops
        ssl["local_crops"] = local_crops
        micros.append({"image": global_crops[:b], "text": captions[labels],
                       "rec_image": global_crops[:b], "ssl": ssl})
        if len(micros) == args.accum_steps:
            yield micros
            micros = []


def to_device(batch: Dict, device) -> Dict:
    """numpy -> tensors on ``device``; token and mask indices as int64."""
    import torch

    def put(k, v):
        if isinstance(v, dict):
            return {kk: put(kk, vv) for kk, vv in v.items()}
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in ("text", "mask_indices"):
            t = t.long()
        return t.to(device)

    return {k: put(k, v) for k, v in batch.items()}


def stack_microbatches(micros: List[Dict]) -> Dict:
    """A list of microbatches -> one batch whose leaves carry a leading
    (accum,) axis; a single microbatch as it is."""
    if len(micros) == 1:
        return micros[0]
    return {k: (stack_microbatches([m[k] for m in micros]) if isinstance(micros[0][k], dict)
                else np.stack([m[k] for m in micros])) for k in micros[0]}


def main(argv: Optional[List[str]] = None) -> Dict:
    """Runs the training and returns ``{"state": the TrainState, "metrics":
    [each step's metrics as floats], "start_step": the first step run}``."""
    args = parse_args(argv)
    if not args.synthetic and not args.data_dir:
        raise SystemExit("pass --data_dir or --synthetic")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    n_seq, n_pipe = args.context_parallel, args.pipeline_parallel
    if args.mesh:
        n_data, n_model = (int(x) for x in args.mesh.split(","))
    else:
        n_data, n_model = world // max(n_seq, 1) // max(n_pipe, 1), 1
    cfg = load_config(args)
    if n_seq > 1 and n_model > 1 and cfg.vision_num_heads % n_model:
        raise SystemExit(f"--context_parallel with a model axis needs vision_num_heads "
                         f"({cfg.vision_num_heads}) % model ({n_model}) == 0")
    if n_seq > 1 and n_data * n_seq * n_model != world:
        raise SystemExit(f"--context_parallel {n_seq} x data {n_data} x model {n_model} != "
                         f"{world} ranks")
    if n_pipe > 1:
        if n_model > 1 or n_seq > 1:
            raise SystemExit("--pipeline_parallel composes with the data axis only (one of "
                             "pipe/seq/model per mesh)")
        if n_data * n_pipe != world:
            raise SystemExit(f"--pipeline_parallel {n_pipe} x data {n_data} != {world} ranks")
        if int(os.environ.get("RANK", "0")) == 0:
            for tower, depth in (("vision", cfg.vision_depth), ("text", cfg.text_depth),
                                 ("decoder", cfg.decoder_depth)):
                if depth % n_pipe:
                    print(f"[train_vtp] note: {tower} depth {depth} % pipe {n_pipe} != 0: that "
                          f"tower runs the sequential loop (data-parallel only)", flush=True)
    if args.sequence_parallel and n_model <= 1:
        raise SystemExit("--sequence_parallel needs a model axis > 1 (--mesh DATA,MODEL); it "
                         "would silently no-op on this mesh")
    if args.tp_head_major and n_model <= 1:
        raise SystemExit("--tp_head_major needs a model axis > 1 (--mesh DATA,MODEL); the "
                         "canonical layout is already optimal single-rank")
    if args.batch_size % (args.accum_steps * n_data):
        raise SystemExit(f"global batch {args.batch_size} must divide by accum_steps x data "
                         f"axis ({args.accum_steps} x {n_data})")
    if n_seq <= 1 and n_pipe <= 1 and (args.mesh or world > 1) and n_data * n_model != world:
        raise SystemExit(f"mesh {n_data}x{n_model} != {world} ranks")

    import torch

    from vtp_tpu_torch.checkpoint import (
        latest_train_state_step,
        restore_train_state,
        save_train_state,
        wait_for_checkpoints,
    )
    from vtp_tpu_torch.convert import save_hf_checkpoint
    from vtp_tpu_torch.parallel.mesh import make_cp_mesh, make_mesh, make_pp_mesh
    from vtp_tpu_torch.parallel.multihost import init_distributed, is_main_process
    from vtp_tpu_torch.tools.train_dit import step_generator
    from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state

    if args.tp_head_major and cfg.vision_num_heads % n_model:
        raise SystemExit(f"--tp_head_major: vision_num_heads {cfg.vision_num_heads} % model "
                         f"{n_model} != 0")
    mesh = None
    if args.mesh or world > 1:
        if "RANK" not in os.environ:
            raise SystemExit("--mesh runs under torchrun (RANK and WORLD_SIZE unset)")
        init_distributed(args.device)
        if n_seq > 1:
            mesh = make_cp_mesh(n_seq, n_data, n_model, device=args.device)
        elif n_pipe > 1:
            mesh = make_pp_mesh(n_pipe, n_data, device=args.device)
        else:
            mesh = make_mesh(n_data, n_model, device=args.device)
    main_rank = is_main_process()
    objectives = set(args.objectives.split(","))
    tcfg = TrainConfig(
        train_clip="clip" in objectives, train_ssl="ssl" in objectives,
        train_reconstruction="rec" in objectives, learning_rate=args.lr,
        weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
        total_steps=args.total_steps or args.steps, teacher_momentum=args.teacher_momentum,
        compute_dtype=None if args.compute_dtype == "fp32" else "bf16",
        remat=(False if (args.no_remat or args.remat == "off")
               else True if args.remat == "full" else args.remat),
        unroll_layers=(args.unroll_chunk or args.unroll_layers),
        accum_steps=args.accum_steps, moment_dtype=args.moment_dtype,
        dino_out_dim=args.dino_out_dim, dino_hidden_dim=args.dino_hidden_dim,
        dino_bottleneck_dim=args.dino_bottleneck_dim, drop_shards=n_data,
        sequence_parallel=args.sequence_parallel, pipeline_stages=n_pipe,
        tp_head_major=n_model if args.tp_head_major else 1,
    )
    state = init_state(cfg, tcfg, torch.Generator(device=args.device).manual_seed(args.seed),
                       device=args.device, mesh=mesh, cp_mode=args.cp_mode)
    start_step = 0
    # the head-major qkv layout is shape-identical to the canonical one, so
    # a sidecar records the layout a run was started with
    meta_path = os.path.join(args.out, "train_meta.json")
    want_hm = state.model.config.vision_qkv_head_major
    if args.resume and latest_train_state_step(args.out) is not None:
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                saved_hm = int(json.load(f).get("qkv_head_major", 1))
            if saved_hm != want_hm:
                raise SystemExit(f"--resume layout mismatch: {args.out} was trained with "
                                 f"qkv_head_major={saved_hm}, this run has {want_hm}")
        state = restore_train_state(args.out, state)
        start_step = state.step
        if main_rank:
            print(f"[train_vtp] resumed from step {start_step}")

    step_fn = build_train_step(cfg, tcfg, mesh)
    n_patches = (cfg.image_size // cfg.vision_patch_size) ** 2
    batches = (synthetic_batches if args.synthetic else folder_batches)(
        args, cfg, n_patches, start_step=start_step)
    drop = [k for k, on in (("image", not tcfg.train_clip), ("text", not tcfg.train_clip),
                            ("rec_image", not tcfg.train_reconstruction),
                            ("ssl", not tcfg.train_ssl)) if on]

    if main_rank:
        os.makedirs(args.out, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump({"qkv_head_major": want_hm}, f)
    history = []
    t0, imgs = time.time(), 0
    for step in range(start_step, args.steps):
        batch = to_device(stack_microbatches(next(batches)), args.device)
        for k in drop:
            batch.pop(k, None)
        state, metrics = step_fn(state, batch, step_generator(args.seed, step, args.device))
        history.append(metrics)  # device scalars: read at a log step or at the end
        imgs += args.batch_size
        if main_rank and ((step + 1) % args.log_every == 0 or step + 1 == args.steps):
            m = {k: float(v) for k, v in metrics.items()}
            losses = " ".join(f"{k.split('/')[-1]}={v:.4f}" for k, v in m.items())
            print(f"[train_vtp] step {step + 1}/{args.steps} {imgs / (time.time() - t0):.1f} "
                  f"img/s {losses}", flush=True)
            if not all(np.isfinite(v) for v in m.values()):
                raise SystemExit(f"non-finite loss at step {step + 1}: {m}")
            t0, imgs = time.time(), 0
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            save_train_state(args.out, state, block=False)
            if main_rank:
                print(f"[train_vtp] checkpoint @ step {step + 1} -> {args.out}", flush=True)

    wait_for_checkpoints()
    if args.export_hf:
        export_dir = os.path.join(args.out, "hf_export")
        save_hf_checkpoint(export_dir, state.model)
        if main_rank:
            print(f"[train_vtp] HF-layout export -> {export_dir}")
    return {"state": state, "start_step": start_step,
            "metrics": [{k: float(v) for k, v in m.items()} for m in history]}


if __name__ == "__main__":
    main()
