#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vtp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. builds the port's CUDA kernels from ``vtp_tpu_torch/csrc`` with nvcc,
   prints ptxas's registers and spills of each kernel and fails if any
   kernel spills; disassembles the library (``cuobjdump -sass``) and fails
   if the exact fp32 arm's kernel holds a tensor-core instruction;
2. holds each kernel against its plain PyTorch version on the card, at the
   main paths' VTP-L shapes and on small cases for every flag: the fused
   attention forward, its backward, the fused DINO/iBOT cross-entropy
   (forward and backward) and the strided attention without a prologue
   (both entries, head dims 32, 64 and 128, the text path's strided view);
   the bf16 forward (with and without qk-norm) and both arms of the
   backward also at the edges of their 64-row tiles, N in EDGE_N (one row,
   ragged tiles, the text length, the 384^2 and 512^2 encodes), with RoPE,
   causal and n_valid cases, the forward's on the inputs of each of
   EDGE_SEEDS; at the same N and on the same seeds the strided attention
   (both entries, head dims 32, 64 and 128, the text view at N = 77;
   ``check_edges_flash``) and the bf16x3 arm on fp32 inputs, with and
   without qk-norm, and the exact fp32 arm the same way at those N and at
   EXACT_EDGE_N (either side of a 64-row tile) (``check_edges_fp32``);
3. runs the roundtrip once through the public API at full VTP-L width:
   ``VTPModel.init`` with seeded random weights, a batch of 8 random 256x256
   images -> bf16 latents -> exact-fp32 images; checks the outputs and that
   every kernel of the path was launched, and compares them with the same
   model run on the plain versions; then the same roundtrip with the
   "high" (bf16x3) decode, counted, against the exact decode of the same
   latents and against the plain versions, and times both;
   serves: writes the model as an HF-layout checkpoint (``save_hf_checkpoint``)
   to a temporary directory, loads it back with ``VTPModel.from_checkpoint``
   at ``decode_precision="high"`` (checked bit for bit), and serves it with
   ``VTPServer`` (batch 32, 5 ms) to concurrent client threads sending
   encode, decode, clip_image and clip_text requests of 1, 3, 8 and 40
   rows; counts the launches, prints rows/s and p50/p99 latency per kind,
   and after shutdown holds every result against a direct call;
   the int8 W8A8 serving tier on the same model: ``torch._int_mm`` against
   the float64 product of the same codes (VTP-L's trunk GEMMs and padded
   small-row cases), ``quantize_for_serving()``'s encode counted, against the
   bf16 encode (cosine > 0.99) and the plain versions, profiled (one
   ``_int_mm`` a linear, no weight-sized copy); the trunk+decoder tier's
   bf16 decode against the exact decode (rel < 0.2, PSNR) and the plain
   versions; ``VTPServer`` over the int8 model against direct calls;
   ``VTPTokenizer(quantize_int8=True)``; the encode timed with the per-call
   cast, ``cast_matmul_params``, ``fuse_ffn_params``, both and int8, in
   turns; peak memory; then ``tools/bench_serve.py``'s ``main`` at VTP-L
   for 5 s (its JSON line printed);
   the head-major checkpoint path: the roundtrip's weights permuted to
   ``vision_qkv_head_major = 4`` (the layout a tensor-parallel run writes),
   written with ``save_pretrained`` (the native format) to a temporary
   directory and loaded back with ``VTPModel.from_checkpoint`` (checked bit
   for bit); its encode, counted (24 ``flash_attention_bnhd`` launches, no
   fused forward), against the canonical model's latents and the plain
   versions, and its roundtrip timed beside the canonical one;
   the non-causal CLIP text path: the VTP-L model with
   ``text_no_causal_mask``, ``get_clip_text_feature`` at B = 32, L = 77,
   counted (12 ``flash_attention`` launches) and against the plain versions;
   the off-gate route: a VTP model at head dim 72 (576 wide, 8 heads,
   depth 2), whose attention takes the split path as the JAX package's
   does, one encode and exact decode at B = 2 with no kernel launched,
   against the plain versions;
   the reconstruction eval: ``evaluate_reconstruction`` on the VTP-L model
   over 32 seeded 256x256 images in batches of 8 (an in-memory loader),
   LPIPS and Inception-v3 from seeded torch-layout state dicts through the
   port's converters, counted, its PSNR, SSIM, LPIPS and rFID against the
   same eval on the plain versions; the zero-shot eval: a synthetic BPE
   merges file, ``build_zero_shot_classifier`` over all 1000 classnames x
   2 templates on the VTP-L text tower (the causal fused launches counted)
   and 64 seeded images scored, the classifier and the logits against the
   plain versions; the linear probe: 26 heads (n 1 and 4 x 13 rates, 1000
   classes) on the VTP-L trunk's frozen last-4-layer features, 4 train
   steps at B = 64 on seeded 224^2 images and ``evaluate_linear_probe`` over
   2 batches, counted, the losses, the heads, the logits and the hit counts
   against the plain versions; text intermediates: the VTP-L text tower's
   ``text_forward_intermediates`` (last 4 layers, normalised) and a
   ``prune_intermediate_layers`` copy's forward at B = 32, counted, against
   the plain versions; the extras: a bf16 ``MultimodalTransformer`` (768
   wide, 12 heads, depth 2; no launch, as in JAX), a bf16
   ``CustomTransformer`` (1024 wide, 16 heads, depth 2; strided
   ``flash_attention``) and an ``AttentionalPooler`` (256 queries) over 256
   seeded 1024-wide context tokens, each counted and against the plain
   versions. (The native ingest library is not driven: the card's machine
   has no libjpeg or libpng headers, so it does not build there);
4. runs the VTP-L CLIP+SSL+rec train step (``init_state``,
   ``build_train_step``; B = 8 images, each with a CLIP pair, a
   reconstruction target and 2 global + 4 local SSL crops) once on the
   kernels, counting their launches, and the same step from the same state
   and batch on the plain versions; compares the losses and the grad norm,
   checks that the state moved, then times steps (images/s, peak memory);
4a. VTP training: the VTP-L step at full width and depth with gradient
   accumulation (B = 16 as 2 microbatches of 8, fp32 accumulators),
   drop-path at 0.1 on every objective and the RoPE coordinate augmentation
   (shift 0.1, jitter 1.2, rescale 2.0), remat on; its draws taken once
   (``sample_draws``), the step on the kernels, counted against
   ``expected_vtp_step_launches`` (the formula printed), and the same step
   with the same draws on the plain versions: losses, grad norm and
   ``objective_grad_norms``, the state moved; then 3 steps timed (peak
   memory). Then ``tools/train_vtp.py``'s ``main`` in process at VTP-L
   widths cut to depth 4 (synthetic, B = 16 as 2 x 8, bf16 moments): 4
   steps of a 6-step schedule with a checkpoint every 2, the restore bit for
   bit, ``--resume`` to 6 with ``--export_hf`` against an uninterrupted
   6-step run (metrics bit for bit), the export read by
   ``VTPModel.from_checkpoint`` with the student's latents, counted;
4b. parallelism (``vtp_tpu_torch.parallel``): a world-size-1 NCCL group
   (rendezvous through a file in a temporary directory) and a (1, 1) mesh;
   the VTP-L step (B = 8) through the parallel path, the data-axis gradient
   all-reduce, tensor parallelism at tp = 1 and FSDP at one shard, none
   short-circuited, counted, against the same step without a mesh (losses
   5e-3 rel, grad norm 2e-2 rel, parameters atol 1e-3 / rtol 5e-3); over the
   same mesh ``VTPServer`` answers each kind of request and
   ``VTPTokenizer(data_sharding=)`` encodes a batch, against direct calls;
   then two spawned ranks share the card over gloo at VTP-L widths (depth
   cut to PAR_DEPTH): data parallelism (2, 1), global B = 8 as 2 x 4 with
   drop_shards = 2, and head-major tensor parallelism (1, 2), 8 trunk heads
   of 64 a rank on the fused forward and backward, each rank against the
   one-process step at the same gates (an arm whose collectives gloo
   refuses on CUDA tensors is left out and named); launches and peak memory
   of each rank printed;
4c. context and pipeline parallelism: two spawned ranks share the card over
   gloo (every collective on ``all_to_all_single``, which gloo carries on
   CUDA tensors) at VTP-L widths, every depth cut to PAR_DEPTH, global B = 8:
   the ring (seq 2, mode "ring") and Ulysses (seq 2, mode "ulysses") on
   ``make_cp_mesh(2, 1)``, the pipeline on ``make_pp_mesh(2, 1)`` with remat
   off and "full"; each arm's step against the one-process step of the same
   state, batch and draws at the parallel phase's gates (flip gate
   included), its launches a rank exactly as ``expected_cp_pp_launches``
   predicts (CP: the fused forward and backward in the text tower alone;
   PP: the one-process step's), its collectives its arm's, the two ranks'
   states equal, peak memory a rank printed; then the ring alone at VTP-L's
   1024^2 token count (4097, padded to 4098; B = 1, 16 heads of 64, bf16
   inputs, fp32 math), forward and backward over the two ranks against the
   one-process plain attention (forward within 5e-2 of max|ref|, gradients
   within 1e-2), each rank's peak beside the one-process peak. A rank that
   fails, gloo refusing a collective included, fails the phase;
5. runs the DiT-XL/1 train step (``init_dit_state``,
   ``build_dit_train_step``; B = 32 latents that ``VTPTokenizer.encode_images``
   makes from seeded random images on the roundtrip's VTP-L model,
   normalised by their per-channel statistics; remat on) the same way: on
   the kernels, counted, then from the same state and draws on the plain
   versions, compared, then timed (samples/s, peak memory). The adaLN-zero
   leaves are first re-drawn from N(0, 0.02^2), since a fresh DiT predicts
   0 and passes no gradient to its attention;
6. samples 8 images with ``sample_images`` (250 euler steps, shift 0.075,
   cfg 1.0, then the VTP-L decode to uint8), counted and timed, and holds
   a 4-step sample's latents against the same on the plain versions; then
   the same with the DiT in int8 W8A8 (``sample_dit --int8``'s
   quantization): a 4-step sample against the plain versions and beside the
   bf16 sampler, and the 250-step sample timed beside the bf16 one;
6a. the generation pipeline (image batches -> latent shards -> DiT training
   -> train-state checkpoints -> samples): the VTP-L model written with
   ``save_hf_checkpoint`` and loaded by ``VTPTokenizer.from_checkpoint``;
   ``tools/extract_latents.extract_latent_shards`` on 64 seeded images and
   their flips at B = 32 into 2 shards of 32, then the statistics, read back
   bit for bit, the latents against the plain versions; DiT-XL/1 fed by
   ``LatentShardDataset`` for 2 steps at B = 32 as 2 microbatches of 16
   (bf16 accumulators and moments, remat "attn": no fused forward in the
   backward), counted and against the same steps on the plain versions,
   then one step each at remat "full" and "dots", counted;
   ``tools/train_dit.py``'s ``main`` in process at DiT-XL/1 cut to depth 4
   (2 steps and a checkpoint, ``--resume`` for a third, and 3 steps
   uninterrupted): the restored state bit for bit, the resumed step against
   the uninterrupted one, write and read timed; ``tools/sample_dit.py``'s
   ``sample_batches`` (4 euler steps, cfg 1.5, the VTP-L decode) on the
   trained EMA against the plain versions and on the EMA restored from the
   depth-4 checkpoint, each counted;
6b. head dims 32 and 128: every forward arm and both backward arms at the
   edge cases at d = 32 and 128, then at each d the VTP-L widths re-cut
   into heads of d (trunk and decoder 1024, text 768; depth 2): the
   roundtrip (exact and "high" decode) and one CLIP+SSL+rec train step,
   and the DiT-XL/1 width (1152) in 36 or 9 heads (depth 2): one train
   step at B = 32 and a 4-step sample; each counted under the arm's name
   at d and against the plain versions;
6c. ZeRO-3 FSDP, tensor parallelism over int8 and fused-w12 weights, the
   parity probe (phase "fsdp zero3, int8 tp, probe"): (a) a world-size-1
   NCCL (1, 1) mesh, the full VTP-L step (B = 8, remat off) on a ZeRO-3
   state at one shard (every parameter read whole through its all-gather,
   re-gathered in the backward, its gradient reduce-scattered: counted in
   ``sharding.CALLS``), its launches exactly the one-process step's, against
   the step without a mesh at ``_hold_step``'s gates; (b) two gloo ranks
   sharing the card, (data 2, model 1), ZeRO-3 at full VTP-L width and
   depth, B = 8: each rank's ``torch.cuda.memory_allocated`` after
   ``shard_state`` against ``sharded_bytes`` (JAX's rule), the step's peak
   and time, its launches, the two ranks' gathered states bit-equal, rank
   0's against (a)'s one-process step; (c) four gloo ranks, (data 2, model
   2), ZeRO-3 x head-major TP at VTP-L widths, depth PAR_DEPTH, B = 8,
   against the one-process step at that depth; (d) the int8 server (every
   tower, ``quantize_for_serving``) and the fused-w12 server over the (1, 1)
   NCCL mesh at full VTP-L and over two gloo ranks (1, 2) at depth
   PAR_DEPTH, each against the same server without a mesh (int8 bit for
   bit, fused at ``run_serve``'s gates); (e) ``python -m
   vtp_tpu_torch.tools.parity_probe --presets vtp-small,vtp-base,vtp-large``
   as a subprocess with a timeout, exit code 0, its deltas beside the JAX
   package's round-5 TPU rows;
7. times each kernel arm against its plain version, a PyTorch yardstick
   call where there is one, and its bound, each by CUDA events twice: as
   the host issues the calls (``ms``, ``plain_ms``, ``library_ms``: a short
   kernel behind a Python wrapper reads the host's cost of a call) and
   queued behind a device sleep (``device_ms``, ``plain_device_ms``,
   ``library_device_ms``: the device's time alone), every forward arm and
   both backward arms also at head dims 32 and 128 (1024 wide); and the
   roundtrip's images/s; the fused forward and backward at the
   tensor-parallel ranks' shapes (``TP_FWD_SHAPES``, ``TP_BWD_SHAPES``)
   beside SDPA and their bound, printed;
8. with --profile, traces one roundtrip, one bf16 and one int8 encode, one
   train step and one DiT train step with torch.profiler and prints the
   device time by kernel and the device's idle share.

Prints the card's name and power limit, one JSON line {"kernels": [...]} and,
as the last line, {"ok": true, "device": {...}}. Exits non-zero, with no
result line, when there is no CUDA device, when the package is missing or
when any phase fails. A watchdog ends the run if it outlasts WATCHDOG_S.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback

WATCHDOG_S = 1100
SEED = 0
BATCH = 8
SOURCE = "vtp_tpu_torch/csrc/fused_attention.cu"
REPLACES = "vtp_tpu/ops/flash_attention.py:423"
BWD_SOURCE = "vtp_tpu_torch/csrc/fused_attention_bwd.cu"
BWD_REPLACES = "vtp_tpu/ops/flash_attention.py:641"
SERVE_BATCH = 32     # VTPServer's defaults: batch 32, 5 ms
SERVE_WAIT_MS = 5.0
SERVE_ROWS = (1, 3, 8, 40)  # rows a request; 40 runs the chunk loop, the rest pad
SERVE_ROUNDS = 2     # each client sends SERVE_ROWS this many times, one request at a time
SERVE_CLIENTS = 2    # client threads a kind
DIT_BATCH = 32     # DiT-XL/1 train microbatch (the TPU bench's)
SAMPLE_BATCH = 8   # images sampled
SAMPLE_STEPS = 250
# The DiT-XL/1 attention (B, N, H, rope grid): 16x16 latents, patch 1, 18 heads of 64
DIT_ATTENTION = (DIT_BATCH, 256, 18, 16)
# Sequence lengths of the attention kernels' edge cases (small B*H): one
# row, ragged tiles of the 64-row tiles, the text length, and the 384^2 and
# 512^2 encodes (24^2 + 1 and 32^2 + 1 tokens)
EDGE_N = (1, 17, 37, 77, 577, 1025)
# Seeds of the forward's edge cases
EDGE_SEEDS = (0, 1, 2, 3, 4, 5, 6, 7)
# The exact fp32 arm's further edges: a 64-row tile less one, one tile, a
# tile plus one
EXACT_EDGE_N = (63, 64, 65)
FLASH_SOURCE = "vtp_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"bnhd": "vtp_tpu/ops/flash_attention.py:953",
                  "bhnd": "vtp_tpu/ops/flash_attention.py:1081"}
HEAD_MAJOR = 4     # the head-major layout of a 4-way tensor-parallel run
# The off-gate model: head dim 72 (576 / 8), which the fused kernel does not take
OFF_GATE_WIDTH, OFF_GATE_HEADS, OFF_GATE_DEPTH, OFF_GATE_BATCH = 576, 8, 2, 2
TEXT_BATCH = 32    # CLIP text rows, at the context length of 77
# The strided kernel's main shapes: the head-major trunk (B, N, H, d) and the
# non-causal text tower (B, N, H, d) = (32, 77, 12, 64)
FLASH_TRUNK = (BATCH, 257, 16, 64)
FLASH_TEXT = (TEXT_BATCH, 77, 12, 64)
CE_SOURCE = "vtp_tpu_torch/csrc/fused_ce.cu"
CE_REPLACES = {"fwd": "vtp_tpu/ops/fused_ce.py:148", "bwd": "vtp_tpu/ops/fused_ce.py:200"}
# The train step's attention call sites (name, B, N, H, rope grid, prefix, causal) at
# B = 8: the trunk on the global crops, on the CLIP/rec images and on the local
# crops; the pixel decoder; the causal text tower
TRAIN_ATTENTION = [("trunk_globals", 2 * BATCH, 257, 16, 16, 1, False),
                   ("trunk_images", BATCH, 257, 16, 16, 1, False),
                   ("trunk_locals", 4 * BATCH, 37, 16, 6, 1, False),
                   ("decoder", BATCH, 256, 16, 16, 0, False),
                   ("text", BATCH, 77, 12, 0, 0, True)]
# The fused CE's rows (name, R, C): iBOT (upperbound 0.5 * 16 * 256), DINO globals, locals
TRAIN_CE = [("ibot", 2048, 65536), ("dino_globals", 2 * BATCH, 65536),
            ("dino_locals", 4 * BATCH, 65536)]
# Head dims 32 and 128: VTP-L's and DiT-XL/1's widths (trunk and decoder
# 1024, text tower 768, DiT 1152) re-cut into heads of 32 and of 128, depth
# cut to HEAD_DIM_DEPTH (never the width); the DiT sample takes
# HEAD_DIM_SAMPLE_STEPS euler steps
HEAD_DIM_HEADS = {32: {"vision": 32, "decoder": 32, "text": 24, "dit": 36},
                  128: {"vision": 8, "decoder": 8, "text": 6, "dit": 9}}
HEAD_DIM_DEPTH = 2
HEAD_DIM_SAMPLE_STEPS = 4
# The reconstruction eval: EVAL_IMAGES seeded 256^2 images in batches of EVAL_BATCH
EVAL_IMAGES, EVAL_BATCH = 32, 8
# The zero-shot eval: every classname with the first ZS_TEMPLATES templates,
# ZS_IMAGES seeded images in batches of ZS_BATCH
ZS_TEMPLATES, ZS_IMAGES, ZS_BATCH = 2, 64, 32
# The linear probe: PROBE_STEPS train steps at B = PROBE_BATCH on seeded
# PROBE_SIZE^2 images, then PROBE_EVAL_BATCHES batches evaluated
PROBE_BATCH, PROBE_STEPS, PROBE_EVAL_BATCHES, PROBE_SIZE = 64, 4, 2, 224
# The extras: EXTRAS_BATCH rows of EXTRAS_CONTEXT seeded trunk-wide (1024)
# tokens as the context, the towers EXTRAS_DEPTH deep
EXTRAS_BATCH, EXTRAS_CONTEXT, EXTRAS_DEPTH = 8, 256, 2
# The generation pipeline (phase 6c): GEN_IMAGES seeded images extracted at
# B = GEN_BATCH (with a flipped copy) into shards of GEN_SHARD rows, DiT-XL/1
# trained GEN_TRAIN_STEPS steps at a global B = GEN_BATCH as GEN_ACCUM
# microbatches (bf16 accumulators and moments, remat "attn"), a train-state
# round trip through tools/train_dit.py at depth GEN_CKPT_DEPTH, and
# GEN_SAMPLE_STEPS euler steps at cfg GEN_CFG for GEN_SAMPLES labels
GEN_IMAGES, GEN_BATCH, GEN_SHARD, GEN_ACCUM, GEN_TRAIN_STEPS = 64, 32, 32, 2, 2
GEN_CKPT_DEPTH, GEN_SAMPLE_STEPS, GEN_CFG, GEN_SAMPLES = 4, 4, 1.5, 8
# VTP training (phase 4a): VTP-L at full width and depth, TrainConfig's
# defaults (remat on) with warmup 0, a global batch of VTP_ACCUM microbatches
# of BATCH in fp32 accumulators, drop rate VTP_DROP on every objective and the
# RoPE coordinate augmentation VTP_ROPE_AUG (shift, jitter, rescale): the
# smoke's choices to drive every branch, not a published recipe; VTP_TIMED
# timed steps. Then tools/train_vtp.py's main at VTP-L widths, every depth cut
# to VTP_CLI_DEPTH: VTP_CLI_STEPS steps of a VTP_CLI_TOTAL-step schedule with
# a checkpoint every VTP_CLI_CKPT, --resume to VTP_CLI_TOTAL, and an
# uninterrupted run (global B = 2 * BATCH as VTP_ACCUM microbatches, bf16
# moments, remat "full")
VTP_ACCUM, VTP_DROP, VTP_ROPE_AUG, VTP_TIMED = 2, 0.1, (0.1, 1.2, 2.0), 3
VTP_CLI_DEPTH, VTP_CLI_STEPS, VTP_CLI_CKPT, VTP_CLI_TOTAL = 4, 4, 2, 6
# The parallel phase (4b): the two-rank gloo arms at VTP-L widths with every
# depth cut to PAR_DEPTH, a global batch of PAR_BATCH (PAR_BATCH / 2 a rank in
# the data-parallel arm), drop-path at PAR_DROP on the SSL branch with
# drop_shards = 2; PAR_TIMEOUT_S bounds the two ranks' run; the server over
# the (1, 1) mesh takes PAR_SERVE_ROWS rows a kind in batches of PAR_SERVE_BATCH
PAR_DEPTH, PAR_BATCH, PAR_DROP, PAR_TIMEOUT_S = 4, 8, 0.1, 400
PAR_SERVE_ROWS, PAR_SERVE_BATCH = 6, 4
# The context and pipeline parallel phase (4c): two gloo ranks on the card at
# VTP-L widths, every depth cut to PAR_DEPTH, a global batch of PAR_BATCH,
# remat off unless the arm says; each arm (name, mesh kind, mesh shape, cp
# mode, TrainConfig overrides) with make_cp_mesh(n_seq, n_data) or
# make_pp_mesh(n_pipe, n_data). Then the ring alone at RING_TOKENS (VTP-L at
# 1024^2: 64^2 patches and the cls token), padded to the seq axis, B = 1,
# RING_HEADS heads of RING_HEAD_DIM in bf16
CPP_ARMS = [("ring_1x2", "cp", (2, 1), "ring", {}),
            ("ulysses_1x2", "cp", (2, 1), "ulysses", {}),
            ("pp_2x1", "pp", (2, 1), "auto", {"pipeline_stages": 2}),
            ("pp_2x1_remat", "pp", (2, 1), "auto", {"pipeline_stages": 2, "remat": "full"})]
RING_TOKENS, RING_HEADS, RING_HEAD_DIM = 4097, 16, 64
RING_FWD_REL, RING_GRAD_REL = 5e-2, 1e-2
# The ZeRO-3, int8 tensor-parallel and probe phase (4d): ZeRO-3 at one shard
# over NCCL (world size 1) and two gloo ranks (data 2) at full VTP-L width and
# depth, B = ZERO3_BATCH, remat off; four gloo ranks (data 2, model 2) at
# depth PAR_DEPTH; the int8 and fused-w12 servers over (1, 1) and, at depth
# PAR_DEPTH, (1, 2); ZERO3_TIMEOUT_S bounds each spawn. A rank's bytes are the
# allocator's requested bytes (its blocks round each up, by up to a block's
# remainder): within ZERO3_BYTES_SLACK of sharded_bytes. The parity probe over
# PROBE_PRESETS, PROBE_PRESET_TIMEOUT_S a preset
ZERO3_BATCH, ZERO3_TIMEOUT_S, ZERO3_BYTES_SLACK = 8, 420, 1 << 20
PROBE_PRESETS, PROBE_PRESET_TIMEOUT_S = ("vtp-small", "vtp-base", "vtp-large"), 240
# The JAX package's round-5 parity-probe rows (PARITY.md; a TPU v5e, not this
# card): encode, decode, loss/total and grad-norm rel deltas
JAX_PROBE_R5 = {"vtp-small": (5.4e-3, 6.9e-5, 5.6e-6, 9.1e-4),
                "vtp-base": (7.4e-3, 1.8e-4, 5.9e-5, 9.6e-4),
                "vtp-large": (1.6e-2, 3.6e-4, 1.1e-5, 9.7e-4)}
# The fused attention at the tensor-parallel ranks' shapes (B, N, H a rank, d):
# VTP-L's 16 heads at tp = 2 and 4, the forward at the encode's B = 8, the
# backward at the train step's global crops (B = 16)
TP_FWD_SHAPES = [(8, 257, 8, 64), (8, 257, 4, 64)]
TP_BWD_SHAPES = [(16, 257, 8, 64), (16, 257, 4, 64)]
# The bf16 features' gate, carried to every comparison of the new phases
# with the plain run (losses: 5e-3 rel)
FEATURE_REL, LOSS_REL = 5e-2, 5e-3
# Published dense peaks (NVIDIA data sheets, SXM parts at 700 W): memory
# bytes/s, bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores.
PEAKS = {"H100": (3.35e12, 989e12, 67e12), "H200": (4.8e12, 989e12, 67e12)}

_phase = "start"


def _set_phase(name: str) -> None:
    global _phase
    _phase = name
    print(f"== {name}", flush=True)


def _watchdog() -> None:
    sys.stderr.write(f"chip_smoke: watchdog fired after {WATCHDOG_S} s in phase {_phase!r}\n")
    sys.stderr.flush()
    os._exit(1)


def _time_ms(fn, iters: int = 10, samples: int = 7, queued: bool = False) -> float:
    """Median over `samples` of the mean time of `iters` calls, by CUDA
    events, after a warm-up. The events bracket the calls as the host issues
    them, so where a Python wrapper takes longer to issue a call than the
    device to run it, the reading is the host's: what a call costs a path
    that the host bounds. With `queued`, each sample's calls wait behind a
    device sleep (``torch.cuda._sleep``) of twice the time the host took to
    issue them, so they run back to back on the device and the reading is
    the device's time alone."""
    import torch

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    sleep_cycles = 0
    if queued:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        e0, e1 = events()
        e0.record()
        torch.cuda._sleep(10 ** 6)
        e1.record()
        e1.synchronize()
        sleep_cycles = int(min(2 * host_ms + 0.5, 200.0) * 10 ** 6 / e0.elapsed_time(e1))
    times = []
    for _ in range(samples):
        e0, e1 = events()
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def _timings(kern, plain, lib=None) -> dict:
    """A kernel row's times: ``ms``, ``plain_ms`` and ``library_ms`` as the
    host issues the calls, and ``device_ms``, ``plain_device_ms`` and
    ``library_device_ms`` queued behind a device sleep (``_time_ms``); the
    library's are None where no single PyTorch call computes the function."""
    out = {}
    for key, fn in (("", kern), ("plain_", plain), ("library_", lib)):
        out[f"{key}ms"] = None if fn is None else _time_ms(fn)
        out[f"{key}device_ms"] = None if fn is None else _time_ms(fn, queued=True)
    return out


def _fmt_times(t: dict, lib: str = "sdpa") -> str:
    """Kernel, plain and library times of ``_timings``, each with its device
    time in brackets."""
    parts = [f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f})",
             f"plain {t['plain_ms']:.4f} ms (device {t['plain_device_ms']:.4f})"]
    if t["library_ms"] is not None:
        parts.append(f"{lib} {t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f})")
    return ", ".join(parts)


def plain_kernels():
    """The package's ``ops.dispatch.plain_kernels()`` (imported when called,
    as every import of the package here): the comparison runs on the
    kernels' plain versions."""
    from vtp_tpu_torch.ops.dispatch import plain_kernels as plain

    return plain()


def _attention_inputs(gen, B, N, H, dtype, grid, prefix, qk_norm=False, d=64):
    """Packed (B, N, 3*H*d) qkv, the RoPE tables of a grid x grid image after
    `prefix` identity rows (or None), and (d,) qk-norm scales (or None)."""
    import torch

    from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device="cuda").to(dtype)
    rope = (None, None)
    if grid:
        rope = pad_rope_prefix(*rope_sincos(rope_periods_init(d, device="cuda"), grid, grid), prefix)
    scales = (None, None)
    if qk_norm:
        scales = tuple(1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda") for _ in range(2))
    return qkv, rope, scales


def check_ptxas(report: str) -> None:
    """Prints ptxas's registers, stack frame and spills of each kernel
    (``-Xptxas -v``, the report kept beside the library) and fails if the
    report names no kernel, or if any kernel spills or keeps a stack frame
    (a local array indexed at run time, or a pointer to a register value)."""
    import re

    name = None
    props = {}
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line) or re.search(
            r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            props.setdefault(name, {}).update(stack=int(m.group(1)),
                                              spill=(int(m.group(2)), int(m.group(3))))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            props.setdefault(name, {})["regs"] = int(m.group(1))
    if not any("regs" in p for p in props.values()):
        raise AssertionError("the ptxas report names no kernel's registers")
    for fn, p in sorted(props.items()):
        print(f"ptxas {fn}: {p.get('regs')} registers, stack frame {p.get('stack')} bytes, spill "
              f"stores/loads {p.get('spill')} bytes", flush=True)
        if p.get("spill", (0, 0)) != (0, 0):
            raise AssertionError(f"the kernel {fn} spills: {p}")
        if p.get("stack", 0):
            raise AssertionError(f"the kernel {fn} has a stack frame: {p}")


def check_sass(lib_path: str) -> None:
    """Disassembles the library (``cuobjdump -sass``, beside nvcc) and fails
    unless the exact fp32 arm's kernel is there once for each head dim of
    FUSED_HEAD_DIMS, each with FFMAs and without a tensor-core instruction
    (any opcode with MMA in it: HMMA, HGMMA, IMMA, DMMA, ...)."""
    import re

    from vtp_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    bodies = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        bodies[name.strip()] = body
    from vtp_tpu_torch.ops.flash_attention import FUSED_HEAD_DIMS

    for d in FUSED_HEAD_DIMS:
        names = [n for n in bodies
                 if "fused_qkv_rope_attention_f32_kernel" in n and f"ILi{d}E" in n]
        if len(names) != 1:
            raise AssertionError(f"the exact fp32 kernel's SASS at d={d} not found once: {names}")
        ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                         bodies[names[0]], re.M)
        mma = sorted({op for op in ops if "MMA" in op})
        print(f"sass fused_qkv_rope_attention_f32_kernel<{d}>: {len(ops)} instructions, "
              f"{ops.count('FFMA')} FFMA, tensor-core instructions {mma or 'none'} "
              f"{'FAIL' if mma or not ops.count('FFMA') else 'ok'}", flush=True)
        if mma or not ops.count("FFMA"):
            raise AssertionError(f"the exact fp32 kernel at d={d} uses tensor cores or no FFMA: "
                                 f"{mma}")


def _edge_inputs(gen, N, rope, qk_norm, B=1, H=2, dtype=None, d=64):
    """qkv (B, N, 3*H*d), bf16 unless ``dtype`` says otherwise; with
    ``rope``, (N, d) sin/cos tables of random angles (column j and j+d/2
    share an angle, as rotate-half RoPE has it), for any N; with
    ``qk_norm``, (d,) scales."""
    import torch

    qkv = torch.randn((B, N, 3 * H * d), generator=gen, device="cuda").to(dtype or torch.bfloat16)
    sin = cos = None
    if rope:
        ang = 2 * math.pi * torch.rand((N, d // 2), generator=gen, device="cuda")
        ang = torch.cat([ang, ang], dim=-1)
        sin, cos = ang.sin(), ang.cos()
    scales = (None, None)
    if qk_norm:
        scales = tuple(1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda") for _ in range(2))
    return qkv, (sin, cos), scales


def _edge_cases(ns=EDGE_N):
    """(name, N, rope, causal, n_valid) at every N of ``ns``."""
    cases = []
    for N in ns:
        nv = max(1, 2 * N // 3)
        cases += [("plain", N, False, False, 0), ("rope", N, True, False, 0),
                  ("causal_rope", N, True, True, 0), ("n_valid_rope", N, True, False, nv),
                  ("causal_n_valid", N, False, True, nv)]
    return cases


def check_edges_fwd(dims=(64,)):
    """The bf16 forward, with and without qk-norm, at every edge case and
    head dim of ``dims``, held to 1e-2 of max|ref| as the bf16 arm's main
    shapes, on the inputs of each of EDGE_SEEDS: its single sweep rounds p
    where the plain version does not, so the margin to the gate is read over
    several draws."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import (
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_reference,
    )

    for d in dims:
        worst = {}
        for seed in EDGE_SEEDS:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            worst[seed] = (0.0, "")
            for qk_norm in (False, True):
                for name, N, rope, causal, n_valid in _edge_cases():
                    qkv, (sin, cos), (qs, ks) = _edge_inputs(gen, N, rope, qk_norm, d=d)
                    got = fused_qkv_rope_attention(qkv, sin, cos, 2, qs, ks, n_valid=n_valid,
                                                   is_causal=causal)
                    torch.cuda.synchronize()
                    want = fused_qkv_rope_attention_reference(qkv, sin, cos, 2, qs, ks,
                                                              n_valid=n_valid, is_causal=causal)
                    err = (got.float() - want.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    ok = err <= 1e-2 * scale and torch.isfinite(got).all().item()
                    if err / scale > worst[seed][0]:
                        worst[seed] = (err / scale, f"{name} qk_norm={qk_norm} N={N}")
                    if not ok:
                        print(f"kernel edge fwd d={d} seed {seed} {name} qk_norm={qk_norm} N={N} "
                              f"n_valid={n_valid}: max abs err {err:.3e} (max|ref| {scale:.3e}; "
                              f"limit 1e-2 rel) FAIL", flush=True)
                        raise AssertionError(f"fused attention edge case {name} N={N} d={d} "
                                             f"disagrees")
        print(f"kernel edge fwd bf16 d={d}, with and without qk-norm, {2 * len(_edge_cases())} "
              f"cases at N in {EDGE_N}, each on the inputs of seeds {EDGE_SEEDS}: worst max abs "
              f"err of max|ref| (limit 1e-2) by seed: "
              + ", ".join(f"{sd}: {w:.3e} ({case})" for sd, (w, case) in worst.items()) + " ok",
              flush=True)


def check_edges_fp32(precision: str, ns, dims=(64,)) -> None:
    """An fp32 arm of the forward (``precision``: "float32", the exact arm,
    or "high", the bf16x3 arm) on fp32 inputs, with and without qk-norm, at
    every edge case at N in ``ns`` and head dim in ``dims``, on the inputs
    of each of EDGE_SEEDS, at the fp32 arms' gates: 1e-4 abs, and 1e-2 of
    max|ref| where qk-norm and RoPE meet (an ulp of the fp32 norm can flip a
    bf16 rounding of RoPE, as in check_kernel). Both arms divide by the
    row's sum at the end, where the plain version normalises p first; the
    bf16x3 arm also splits the unnormalised p."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import (
        arm_name,
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_reference,
    )

    arm = arm_name(torch.float32, precision)
    for d in dims:
        worst = {}
        for seed in EDGE_SEEDS:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            worst[seed] = {"abs": (0.0, ""), "rel": (0.0, "")}
            for qk_norm in (False, True):
                for name, N, rope, causal, n_valid in _edge_cases(ns):
                    qkv, (sin, cos), (qs, ks) = _edge_inputs(gen, N, rope, qk_norm,
                                                             dtype=torch.float32, d=d)
                    got = fused_qkv_rope_attention(qkv, sin, cos, 2, qs, ks, n_valid=n_valid,
                                                   is_causal=causal, fp32_precision=precision)
                    torch.cuda.synchronize()
                    want = fused_qkv_rope_attention_reference(qkv, sin, cos, 2, qs, ks,
                                                              n_valid=n_valid, is_causal=causal,
                                                              fp32_precision=precision)
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    kind = "rel" if qk_norm and rope else "abs"
                    value = err / scale if kind == "rel" else err
                    limit = 1e-2 if kind == "rel" else 1e-4
                    if value > worst[seed][kind][0]:
                        worst[seed][kind] = (value, f"{name} qk_norm={qk_norm} N={N}")
                    if not (value <= limit and torch.isfinite(got).all().item()):
                        print(f"kernel edge {arm} d={d} seed {seed} {name} qk_norm={qk_norm} N={N} "
                              f"n_valid={n_valid}: max abs err {err:.3e} (max|ref| {scale:.3e}; "
                              f"limit {limit} {kind}) FAIL", flush=True)
                        raise AssertionError(f"{arm} attention edge case {name} N={N} d={d} "
                                             f"disagrees")
        print(f"kernel edge {arm} d={d}, with and without qk-norm, {2 * len(_edge_cases(ns))} "
              f"cases at N in {ns}, each on the inputs of seeds {EDGE_SEEDS}: worst max abs err "
              f"(limit 1e-4) and, with qk-norm and RoPE, worst of max|ref| (limit 1e-2) by seed: "
              + ", ".join(f"{sd}: {w['abs'][0]:.3e} ({w['abs'][1]}) / {w['rel'][0]:.3e} "
                          f"({w['rel'][1]})" for sd, w in worst.items()) + " ok", flush=True)


def check_edges_bwd(gen, qk_norm, dims=(64,)):
    """The backward's arm (without or with qk-norm) at every edge case and
    head dim of ``dims``: d(qkv) within 1e-2 of max|ref|, dw_q and dw_k
    within 1e-2 relative."""
    import torch

    from vtp_tpu_torch.ops import flash_attention as fa

    for d in dims:
        worst = worst_dw = 0.0
        for name, N, rope, causal, n_valid in _edge_cases():
            qkv, (sin, cos), (qs, ks) = _edge_inputs(gen, N, rope, qk_norm, d=d)
            g = torch.randn((1, N, 2 * d), generator=gen, device="cuda").bfloat16()
            if qk_norm:
                got = fa.fused_qkv_rope_attention_qk_norm_bwd(qkv, g, sin, cos, qs, ks, 2, n_valid,
                                                              causal)
                torch.cuda.synchronize()
                want = fa.fused_qkv_rope_attention_qk_norm_bwd_reference(qkv, g, sin, cos, qs, ks,
                                                                         2, n_valid, causal)
            else:
                got = (fa.fused_qkv_rope_attention_bwd(qkv, g, sin, cos, 2, n_valid, causal),)
                torch.cuda.synchronize()
                want = (fa.fused_qkv_rope_attention_bwd_reference(qkv, g, sin, cos, 2, n_valid,
                                                                   causal),)
            err = (got[0].float() - want[0].float()).abs().max().item()
            scale = want[0].float().abs().max().item()
            # at N = 1 the one key takes p = 1, so ds, dq, dk and dw are exactly 0
            dw_err = max([0.0] + [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                                  for a, b in zip(got[1:], want[1:])])
            worst, worst_dw = max(worst, err / scale), max(worst_dw, dw_err)
            ok = (err <= 1e-2 * scale and dw_err <= 1e-2
                  and all(torch.isfinite(t).all().item() for t in got))
            if not ok:
                print(f"kernel edge bwd d={d} {name} qk_norm={qk_norm} N={N} n_valid={n_valid}: "
                      f"d(qkv) max abs err {err:.3e} (max|ref| {scale:.3e}; limit 1e-2 rel), dw max "
                      f"rel err {dw_err:.3e} (limit 1e-2) FAIL", flush=True)
                raise AssertionError(f"attention backward edge case {name} N={N} d={d} disagrees")
        arm = "qk-norm arm" if qk_norm else "no-norm arm"
        print(f"kernel edge bwd {arm} d={d}, {len(_edge_cases())} cases at N in {EDGE_N}: worst "
              f"d(qkv) max abs err {worst:.3e} of max|ref| (limit 1e-2)"
              + (f", worst dw rel err {worst_dw:.3e} (limit 1e-2)" if qk_norm else "") + " ok",
              flush=True)


def check_kernel(gen):
    """Phase 2: the kernel against its plain version. Returns the error of
    each arm at the main path's shapes."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import (
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_reference,
    )

    bf16, fp32 = torch.bfloat16, torch.float32
    # name, B, N, H, dtype, rope grid (0 = none), prefix, n_valid, causal, qk_norm, tol kind,
    # fp32 precision; the bf16x3 ("high") arm is held to the exact fp32 arm's tolerances
    cases = [
        ("vtpl_encode", BATCH, 257, 16, bf16, 16, 1, 0, False, False, "rel", "float32"),
        ("vtpl_decode", BATCH, 256, 16, fp32, 16, 0, 0, False, False, "abs", "float32"),
        ("vtpl_decode", BATCH, 256, 16, fp32, 16, 0, 0, False, False, "abs", "high"),
    ]
    for dt, prec in ((bf16, "float32"), (fp32, "float32"), (fp32, "high")):
        tol = "rel" if dt is bf16 else "abs"
        cases += [
            ("n_valid", 2, 197, 4, dt, 14, 1, 190, False, False, tol, prec),
            ("causal", 2, 197, 4, dt, 0, 0, 0, True, False, tol, prec),
            ("causal_n_valid_rope", 2, 197, 4, dt, 14, 1, 150, True, False, tol, prec),
            ("qk_norm", 2, 197, 4, dt, 0, 0, 0, False, True, tol, prec),
            # the fp32 arms rope in bf16 after an fp32 norm whose sum order
            # differs from torch's, so an ulp there can flip a bf16 rounding:
            # this case is held to the bf16 tolerance in every arm
            ("qk_norm_rope", 2, 197, 4, dt, 14, 1, 0, False, True, "rel", prec),
        ]
    errs = {}
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in exact fp32
    torch.backends.cudnn.allow_tf32 = False
    for name, B, N, H, dt, grid, prefix, n_valid, causal, qk_norm, tol_kind, prec in cases:
        qkv, (sin, cos), (qs, ks) = _attention_inputs(gen, B, N, H, dt, grid, prefix, qk_norm)
        got = fused_qkv_rope_attention(qkv, sin, cos, H, qs, ks, n_valid=n_valid, is_causal=causal,
                                       fp32_precision=prec)
        torch.cuda.synchronize()
        want = fused_qkv_rope_attention_reference(qkv, sin, cos, H, qs, ks, n_valid=n_valid,
                                                  is_causal=causal, fp32_precision=prec)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = (err <= 1e-2 * scale) if tol_kind == "rel" else (err <= 1e-4)
        limit = "1e-2 rel of max|ref|" if tol_kind == "rel" else "1e-4 abs"
        arm = "bf16" if dt is bf16 else ("fp32" if prec == "float32" else "fp32_bf16x3")
        print(f"kernel {name:20s} {arm} B={B} N={N} H={H}: max abs err {err:.3e} "
              f"(max|ref| {scale:.3e}; limit {limit}) {'ok' if ok else 'FAIL'}", flush=True)
        if not (ok and torch.isfinite(got).all().item()):
            raise AssertionError(f"fused attention {name} ({arm}) disagrees with its plain version")
        if name.startswith("vtpl_"):
            errs[arm] = err
    check_edges_fwd()
    check_edges_fp32("float32", tuple(sorted(EDGE_N + EXACT_EDGE_N)))
    check_edges_fp32("high", EDGE_N)
    return errs


def run_roundtrip(gen):
    """Phase 3: the roundtrip at full VTP-L width, once, counted."""
    import torch

    from vtp_tpu_torch import VTPModel, vtp_large
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME

    cfg = vtp_large()
    model = VTPModel.init(cfg, gen, device="cuda")
    images = torch.randn((BATCH, 3, cfg.image_size, cfg.image_size), generator=gen, device="cuda")
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    latents = model.get_reconstruction_latents(images)
    recon = model.get_latents_decoded_images(latents)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    print(f"roundtrip: first call {first_s:.3f} s; kernel launches {counts}", flush=True)
    want = {ARM_NAME[torch.bfloat16]: cfg.vision_depth, ARM_NAME[torch.float32]: cfg.decoder_depth}
    if counts != want:
        raise AssertionError(f"main path launches {counts}, expected {want}")

    g = cfg.image_size // cfg.vision_patch_size
    if tuple(latents.shape) != (BATCH, cfg.vision_feature_bottleneck, g, g) or latents.dtype != torch.bfloat16:
        raise AssertionError(f"latents {tuple(latents.shape)} {latents.dtype}")
    if tuple(recon.shape) != tuple(images.shape) or recon.dtype != torch.float32:
        raise AssertionError(f"images {tuple(recon.shape)} {recon.dtype}")
    if not (torch.isfinite(latents).all().item() and torch.isfinite(recon).all().item()):
        raise AssertionError("non-finite roundtrip output")

    with plain_kernels():
        ref_latents = model.get_reconstruction_latents(images)
        ref_recon = model.get_latents_decoded_images(latents)
    torch.cuda.synchronize()
    lat_err = ((latents.float() - ref_latents.float()).abs().max()
               / ref_latents.float().abs().max()).item()
    img_err = (recon - ref_recon).abs().max().item()
    print(f"roundtrip vs plain versions: latents max err {lat_err:.3e} of max|ref| (limit 5e-2), "
          f"images max abs err {img_err:.3e} (limit 1e-3; max|ref| "
          f"{ref_recon.abs().max().item():.3e})", flush=True)
    if not (lat_err <= 5e-2 and img_err <= 1e-3):
        raise AssertionError("roundtrip disagrees with the plain-version run")

    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.get_latents_decoded_images(model.get_reconstruction_latents(images))
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    rt_s = statistics.median(samples)
    return counts, rt_s, model, images


def run_high_roundtrip(model, images, exact_s):
    """Phase 3b: the roundtrip with the "high" (bf16x3) decode, once,
    counted; its images against the exact decode of the same latents
    (within 1e-3 of max|ref|) and against the plain versions at "high"
    (within 1e-3 abs, as the exact roundtrip); then timed beside the exact
    roundtrip."""
    import torch

    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, HIGH_NAME

    cfg = model.config
    torch.cuda.synchronize()
    reset_launch_counts()
    latents = model.get_reconstruction_latents(images)
    high = model.get_latents_decoded_images(latents, precision="high")
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {ARM_NAME[torch.bfloat16]: cfg.vision_depth, HIGH_NAME: cfg.decoder_depth}
    print(f"high roundtrip: kernel launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"high roundtrip launches {counts}, expected {want}")
    if tuple(high.shape) != tuple(images.shape) or high.dtype != torch.float32:
        raise AssertionError(f"high images {tuple(high.shape)} {high.dtype}")
    exact = model.get_latents_decoded_images(latents, precision="float32")
    with plain_kernels():
        plain = model.get_latents_decoded_images(latents, precision="high")
    torch.cuda.synchronize()
    scale = exact.abs().max().item()
    err = (high - exact).abs().max().item() / scale
    plain_err = (high - plain).abs().max().item()
    ok = err <= 1e-3 and plain_err <= 1e-3 and torch.isfinite(high).all().item()
    print(f"high decode vs exact decode of the same latents: max abs err {err:.3e} of max|ref| "
          f"({scale:.3e}; limit 1e-3); vs plain versions at high: max abs err {plain_err:.3e} "
          f"(limit 1e-3) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the high decode disagrees with the exact decode or the plain run")
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.get_latents_decoded_images(model.get_reconstruction_latents(images), precision="high")
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    high_s = statistics.median(samples)
    print(f"roundtrip VTP-L 256px B={BATCH}, high decode: {high_s * 1e3:.2f} ms, "
          f"{BATCH / high_s:.2f} images/s; exact decode: {exact_s * 1e3:.2f} ms, "
          f"{BATCH / exact_s:.2f} images/s (host clock, median of 5 each)", flush=True)
    return counts


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


def run_serve(model, card):
    """Phase 3c: the serving path. save_hf_checkpoint to a temporary
    directory, VTPModel.from_checkpoint at decode_precision="high" (the
    state checked bit for bit), VTPServer(batch 32, 5 ms) under
    SERVE_CLIENTS client threads a kind, each sending SERVE_ROWS requests
    SERVE_ROUNDS times, one at a time; launches counted against the
    server's model calls. After shutdown every result is held against a
    direct call on the same rows: bf16 paths within 5e-2 of max|ref|, the
    "high" decode within 1e-4 of max|ref| (another batch size may take
    another cuBLAS algorithm, so sums come in another order)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.convert import save_hf_checkpoint
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, HIGH_NAME
    from vtp_tpu_torch.serve import VTPServer

    cfg = model.config
    n_bytes = sum(t.numel() * 4 for t in model.state_dict().values())
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    if free < 2 * n_bytes:
        raise AssertionError(f"{tmp} has {free / 1e9:.1f} GB free; the checkpoint needs "
                             f"{n_bytes / 1e9:.1f} GB")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_hf_checkpoint(d, model)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        t0 = time.perf_counter()
        loaded = VTPModel.from_checkpoint(d, device="cuda", decode_precision="high")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    same = _same_state(model, loaded)
    print(f"serve: checkpoint of {size / 1e9:.2f} GB written in {save_s:.1f} s, loaded by "
          f"VTPModel.from_checkpoint in {load_s:.1f} s (warm page cache); state bit for bit "
          f"{'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("the loaded checkpoint differs from the saved model")

    rng = np.random.default_rng(SEED)
    s, g = cfg.image_size, cfg.image_size // cfg.vision_patch_size
    make = {
        "encode": lambda n: rng.standard_normal((n, 3, s, s), dtype=np.float32),
        "decode": lambda n: rng.standard_normal((n, cfg.vision_feature_bottleneck, g, g),
                                                dtype=np.float32),
        "clip_image": lambda n: rng.standard_normal((n, 3, s, s), dtype=np.float32),
        "clip_text": lambda n: rng.integers(1, cfg.text_vocab_size - 1,
                                            (n, cfg.text_context_length)),
    }
    clients = [(kind, [make[kind](n) for _ in range(SERVE_ROUNDS) for n in SERVE_ROWS])
               for kind in make for _ in range(SERVE_CLIENTS)]

    srv = VTPServer(loaded, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS)

    def client(kind, payloads):
        done = []
        for x in payloads:
            t0 = time.perf_counter()
            y = srv.submit(kind, x).result(timeout=300)
            done.append((time.perf_counter() - t0, x, y))
        return kind, done

    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(clients)) as pool:
            served = [job.result() for job in [pool.submit(client, *c) for c in clients]]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = launch_counts()
        calls = dict(srv.calls)
    finally:
        srv.shutdown()
    want = {ARM_NAME[torch.bfloat16]: cfg.vision_depth * (calls["encode"] + calls["clip_image"])
            + cfg.text_depth * calls["clip_text"],
            HIGH_NAME: cfg.decoder_depth * calls["decode"]}
    print(f"serve: model calls {calls}; kernel launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"serve launches {counts}, expected {want}")
    by_kind = {}
    for kind, done in served:
        by_kind.setdefault(kind, []).extend(done)
    for kind, done in by_kind.items():
        lat = [t * 1e3 for t, _, _ in done]
        rows = sum(x.shape[0] for _, x, _ in done)
        print(f"serve {kind:10s} on {card}: {len(done)} requests, {rows} rows, "
              f"{rows / wall:.1f} rows/s over the {wall:.3f} s run of all kinds together; "
              f"latency p50 {_percentile(lat, 50):.1f} ms, p99 {_percentile(lat, 99):.1f} ms "
              f"(host clock, {len(done)} samples)", flush=True)

    enc = loaded.encode_dtype
    direct = {"encode": loaded.get_reconstruction_latents,
              "decode": loaded.get_latents_decoded_images,
              "clip_image": lambda x: loaded.get_clip_image_feature(x, True, enc),
              "clip_text": lambda x: loaded.get_clip_text_feature(x, True, enc)}
    for kind, done in by_kind.items():
        limit = 1e-4 if kind == "decode" else 5e-2
        worst = 0.0
        for _, x, y in done:
            ref = direct[kind](torch.as_tensor(x).cuda()).float().cpu()
            if tuple(y.shape) != tuple(ref.shape):
                raise AssertionError(f"serve {kind}: result {tuple(y.shape)}, direct {tuple(ref.shape)}")
            worst = max(worst, ((y.float() - ref).abs().max() / ref.abs().max()).item())
        ok = worst <= limit
        print(f"serve {kind:10s} vs direct calls on the same rows: max err {worst:.3e} of "
              f"max|ref| (limit {limit:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"served {kind} results disagree with direct calls")
    return counts


# The int8 product's main shapes: VTP-L's trunk GEMMs at B = 8 (2056 rows:
# qkv, proj, w1 / w2, w3), and rows the card's _int_mm does not take, padded:
# the DiT's ada at B = 8 and its t_embed fc1 at the CFG-doubled B = 16
INT8_GEMMS = ((2056, 1024, 3072), (2056, 1024, 1024), (2056, 1024, 2736), (2056, 2736, 1024),
              (8, 1152, 6912), (16, 256, 1152))
INT8_SAMPLES = 7   # rounds of the encode timings, each variant once a round, in turns


def check_int_mm(card):
    """Phase 3d (a): ``int8_matmul`` (``torch._int_mm`` on the column-major
    codes, small row counts padded) against the float64 product of the same
    int8 codes, bit for bit, at INT8_GEMMS."""
    import torch

    from vtp_tpu_torch.utils.quantization import int8_matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for m, k, n in INT8_GEMMS:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        acc = int8_matmul(xq, q)
        exact = acc.dtype == torch.int32 and torch.equal(acc.double(), xq.double() @ q.double().t())
        ms = _time_ms(lambda: int8_matmul(xq, q))
        print(f"int8 GEMM ({m}, {k}) x ({k}, {n}) on {card}: int32 accumulators equal to the "
              f"float64 product {'ok' if exact else 'FAIL'}; {ms:.4f} ms, "
              f"{2 * m * k * n / ms / 1e9:.1f} TOP/s (CUDA events, median of 7 x 10)", flush=True)
        if not exact:
            raise AssertionError(f"torch._int_mm disagrees with the float64 product at {m, k, n}")


def _encode_times(variants, images):
    """Host-clock ms of each variant's encode, INT8_SAMPLES rounds, the
    variants in turns within a round: {label: [ms, ...]}."""
    import torch

    times = {label: [] for label in variants}
    for fn in variants.values():
        fn(images)
    for _ in range(INT8_SAMPLES):
        for label, fn in variants.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(images)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
    return times


def _psnr_255(images, ref):
    """PSNR of de-normalised (ImageNet mean/std) images in [0, 255]."""
    import torch

    from vtp_tpu_torch.generation.vtp_tokenizer import IMAGENET_MEAN, IMAGENET_STD
    from vtp_tpu_torch.metrics.psnr import psnr

    mean = torch.tensor(IMAGENET_MEAN, device=ref.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=ref.device).reshape(1, 3, 1, 1)
    to255 = lambda x: torch.clamp((x.float() * std + mean) * 255.0, 0, 255)
    return psnr(to255(ref), to255(images)).mean().item()


def run_int8_serving(model, images, card, profiling=False):
    """Phase 3d: the int8 W8A8 serving tier on the roundtrip's VTP-L model.
    ``torch._int_mm`` checked (``check_int_mm``); ``quantize_for_serving()``
    (trunk): its encode counted (24 bf16-arm launches), against the bf16
    encode (cosine > 0.99, JAX's gate) and the plain versions (5e-2 of
    max|ref|), profiled (120 ``_int_mm`` calls, no copy of a weight-sized
    tensor); the trunk+decoder tier: a bf16 decode (counted), within rel 0.2
    of the exact decode of the same latents (JAX's gate), its PSNR, against
    the plain versions, and its decoder refusing the fp32 decode;
    ``VTPServer`` over the int8 model (every result against a direct call);
    ``VTPTokenizer(quantize_int8=True)``; the encode timed with the
    per-call cast, ``cast_matmul_params`` (bit-equal), ``fuse_ffn_params``,
    both, and int8; peak memory; with ``profiling``, the bf16 and the int8
    encode traced (``profile_run``). Returns the launches of the counted
    runs."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vtp_tpu_torch.generation import VTPTokenizer
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME
    from vtp_tpu_torch.serve import VTPServer
    from vtp_tpu_torch.utils.params import cast_matmul_params, fuse_ffn_params, tree_bytes
    from vtp_tpu_torch.utils.quantization import Int8Weight, shallow_copy

    cfg = model.config
    bf16 = ARM_NAME[torch.bfloat16]
    total = {}

    def add(counts):
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    check_int_mm(card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    qmodel = model.quantize_for_serving()
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated() - base
    print(f"int8: quantize_for_serving() in place of {tree_bytes(model.trunk) / 1e9:.3f} GB of "
          f"fp32 trunk holds {tree_bytes(qmodel.trunk) / 1e9:.3f} GB; allocated "
          f"{added / 1e9:.3f} GB more (the other towers shared)", flush=True)
    if qmodel.pixel_decoder is not model.pixel_decoder or qmodel.text is not model.text:
        raise AssertionError("quantize_for_serving copied a tower it does not quantize")

    reset_launch_counts()
    z8 = qmodel.get_reconstruction_latents(images)
    torch.cuda.synchronize()
    counts = launch_counts()
    add(counts)
    want = {bf16: cfg.vision_depth}
    print(f"int8 encode: kernel launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"int8 encode launches {counts}, expected {want}")
    z16 = model.get_reconstruction_latents(images)
    with plain_kernels():
        z8_plain = qmodel.get_reconstruction_latents(images)
    torch.cuda.synchronize()
    a, b = z8.float().ravel(), z16.float().ravel()
    cos = (a @ b / (a.norm() * b.norm())).item()
    rel = ((a - b).norm() / b.norm()).item()
    err = ((z8.float() - z8_plain.float()).abs().max() / z8_plain.float().abs().max()).item()
    ok = cos > 0.99 and err <= FEATURE_REL and torch.isfinite(z8).all().item()
    print(f"int8 encode VTP-L B={BATCH} on {card}: vs the bf16 encode cosine {cos:.6f} (limit > "
          f"0.99), relative error {rel:.4e}; vs plain versions max err {err:.3e} of max|ref| "
          f"(limit {FEATURE_REL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the int8 encode disagrees with the bf16 encode or the plain run")

    weight_shapes = {tuple(m.q.shape) for m in qmodel.trunk.modules() if isinstance(m, Int8Weight)}
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        qmodel.get_reconstruction_latents(images)
        torch.cuda.synchronize()
    n_mm = sum(1 for e in prof.events() if e.name == "aten::_int_mm")
    weight_copies = sum(1 for e in prof.events() if e.name == "aten::copy_" and any(
        tuple(s) in weight_shapes or tuple(s[::-1]) in weight_shapes
        for s in (e.input_shapes or []) if s))
    linears = 5 * cfg.vision_depth
    print(f"int8 encode profile: {n_mm} aten::_int_mm calls (expected {linears}), {weight_copies} "
          f"aten::copy_ of a weight-sized tensor (expected 0)", flush=True)
    if n_mm != linears or weight_copies:
        raise AssertionError("the int8 encode did not run one _int_mm a linear without copies")

    qdec = model.quantize_for_serving(("trunk", "pixel_decoder"))
    if qdec.decode_dtype != torch.bfloat16:
        raise AssertionError(f"the decoder tier decodes in {qdec.decode_dtype}, not bf16")
    try:
        qdec.pixel_decoder(z8)
    except ValueError:
        pass
    else:
        raise AssertionError("the int8 decoder ran the fp32 protocol decode")
    reset_launch_counts()
    rec8 = qdec.get_latents_decoded_images(z8)
    torch.cuda.synchronize()
    counts = launch_counts()
    add(counts)
    want = {bf16: cfg.decoder_depth}
    print(f"int8 decoder tier decode: kernel launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"int8 decoder tier launches {counts}, expected {want}")
    exact = model.get_latents_decoded_images(z8)
    with plain_kernels():
        rec8_plain = qdec.get_latents_decoded_images(z8)
    torch.cuda.synchronize()
    rel = ((rec8.float() - exact).norm() / exact.norm()).item()
    err = ((rec8.float() - rec8_plain.float()).abs().max() / rec8_plain.float().abs().max()).item()
    ok = rel < 0.2 and err <= FEATURE_REL and torch.isfinite(rec8).all().item()
    print(f"int8 trunk+decoder tier on {card}: bf16 decode vs the exact decode of the same "
          f"latents rel {rel:.4e} (limit 0.2), PSNR {_psnr_255(rec8, exact):.2f} dB (ImageNet "
          f"de-normalised, [0, 255]); vs plain versions max err {err:.3e} of max|ref| (limit "
          f"{FEATURE_REL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the int8 decoder tier disagrees with the exact decode or plain run")
    del qdec, rec8, rec8_plain, exact

    rng = np.random.default_rng(SEED + 3)
    s, g = cfg.image_size, cfg.image_size // cfg.vision_patch_size
    make = {
        "encode": lambda n: rng.standard_normal((n, 3, s, s), dtype=np.float32),
        "decode": lambda n: rng.standard_normal((n, cfg.vision_feature_bottleneck, g, g),
                                                dtype=np.float32),
        "clip_image": lambda n: rng.standard_normal((n, 3, s, s), dtype=np.float32),
        "clip_text": lambda n: rng.integers(1, cfg.text_vocab_size - 1,
                                            (n, cfg.text_context_length)),
    }
    srv = VTPServer(qmodel, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS)
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        futures = [(kind, x, srv.submit(kind, x)) for kind in make
                   for x in (make[kind](n) for n in SERVE_ROWS)]
        served = [(kind, x, f.result(timeout=300)) for kind, x, f in futures]
        torch.cuda.synchronize()
        counts = launch_counts()
        calls = dict(srv.calls)
    finally:
        srv.shutdown()
    add(counts)
    want = {bf16: cfg.vision_depth * (calls["encode"] + calls["clip_image"])
            + cfg.text_depth * calls["clip_text"],
            ARM_NAME[torch.float32]: cfg.decoder_depth * calls["decode"]}
    print(f"int8 serve: model calls {calls}; kernel launches {counts} (expected {want})",
          flush=True)
    if counts != want:
        raise AssertionError(f"int8 serve launches {counts}, expected {want}")
    enc = qmodel.encode_dtype
    direct = {"encode": qmodel.get_reconstruction_latents,
              "decode": qmodel.get_latents_decoded_images,
              "clip_image": lambda x: qmodel.get_clip_image_feature(x, True, enc),
              "clip_text": lambda x: qmodel.get_clip_text_feature(x, True, enc)}
    worst = {}
    for kind, x, y in served:
        ref = direct[kind](torch.as_tensor(x).cuda()).float().cpu()
        if tuple(y.shape) != tuple(ref.shape):
            raise AssertionError(f"int8 serve {kind}: result {tuple(y.shape)}, direct "
                                 f"{tuple(ref.shape)}")
        err = ((y.float() - ref).abs().max() / ref.abs().max()).item()
        worst[kind] = max(worst.get(kind, 0.0), err)
    ok = all(v <= FEATURE_REL for v in worst.values())
    print(f"int8 serve vs direct calls on the same rows: max err of max|ref| "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } (limit {FEATURE_REL:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("served int8 results disagree with direct calls")

    reset_launch_counts()
    tok = VTPTokenizer(model, img_size=cfg.image_size, quantize_int8=True)
    zt = tok.encode_images(images)
    torch.cuda.synchronize()
    counts = launch_counts()
    add(counts)
    ok = counts == {bf16: cfg.vision_depth} and torch.equal(zt, z8.float())
    print(f"VTPTokenizer(quantize_int8=True).encode_images: {tuple(zt.shape)} {zt.dtype}, "
          f"launches {counts}, equal to the int8 model's latents {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the int8 tokenizer's encode differs from the int8 model's")
    del tok, zt

    cast = shallow_copy(model)
    cast.trunk = cast_matmul_params(model.trunk)
    fused = shallow_copy(model)
    fused.trunk = fuse_ffn_params(model.trunk)
    both = shallow_copy(model)
    both.trunk = fuse_ffn_params(cast.trunk)
    zc, zf, zb = (m.get_reconstruction_latents(images) for m in (cast, fused, both))
    torch.cuda.synchronize()
    errs = [((z.float() - z16.float()).abs().max() / z16.float().abs().max()).item()
            for z in (zf, zb)]
    ok = torch.equal(zc, z16) and max(errs) <= FEATURE_REL
    print(f"param transforms: cast_matmul_params latents bit-equal to the per-call cast "
          f"{'ok' if torch.equal(zc, z16) else 'FAIL'}; fuse_ffn_params {errs[0]:.3e}, cast + "
          f"fuse {errs[1]:.3e} of max|ref| (limit {FEATURE_REL:g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("a param transform changed the encode")
    variants = {"bf16, per-call cast": model.get_reconstruction_latents,
                "cast_matmul_params": cast.get_reconstruction_latents,
                "fuse_ffn_params": fused.get_reconstruction_latents,
                "cast + fuse": both.get_reconstruction_latents,
                "int8 W8A8": qmodel.get_reconstruction_latents}
    times = _encode_times(variants, images)
    for label, ts in times.items():
        print(f"encode VTP-L 256px B={BATCH}, {label:20s} on {card}: median "
              f"{statistics.median(ts):.2f} ms (min {min(ts):.2f}, max {max(ts):.2f}; host clock, "
              f"{len(ts)} samples, the five variants in turns)", flush=True)
    print(f"int8 serving phase: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated) on {card}", flush=True)
    if profiling:
        profile_run("bf16 encode", lambda: model.get_reconstruction_latents(images))
        profile_run("int8 encode", lambda: qmodel.get_reconstruction_latents(images))
    return total


def run_bench_serve(card):
    """Phase 3e: ``tools/bench_serve.main`` at VTP-L for 5 s (its own seeded
    model); its JSON line is printed before the result line."""
    from vtp_tpu_torch.tools import bench_serve

    print(f"bench_serve on {card}: VTP-L, 5 s, encode + decode + clip_image clients, 8-row "
          f"requests, batch 32", flush=True)
    result = bench_serve.main(["--preset", "vtp-large", "--seconds", "5", "--device", "cuda"])
    if not result["value"] > 0 or set(result["kinds"]) != {"encode", "decode", "clip_image"}:
        raise AssertionError(f"bench_serve served nothing: {result}")


def run_int8_sampling(gen, state, tokenizer, stats, bf16_sample_s, card):
    """Phase 6b: the int8 DiT-XL/1 (``sample_dit --int8``'s quantization:
    every linear but ``x_embed`` and ``final``): a 4-step sample counted,
    against the same int8 sampler on the plain versions (5e-2 of max|ref|)
    and beside the bf16 sampler (JAX's rel 0.15); then SAMPLE_BATCH images
    at SAMPLE_STEPS steps, counted and timed beside the bf16 sample."""
    import torch

    from vtp_tpu_torch.dit.sample import make_sampler, sample_images
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, NORM_NAME
    from vtp_tpu_torch.tools.sample_dit import quantize_dit_for_serving

    cfg = state.ema.config
    q_ema = quantize_dit_for_serving(state.ema)
    labels = torch.arange(SAMPLE_BATCH, device="cuda") * (cfg.num_classes // SAMPLE_BATCH)
    shape = (SAMPLE_BATCH, cfg.in_channels, cfg.input_size, cfg.input_size)
    noise = torch.randn(shape, generator=gen, device="cuda")
    short = make_sampler(cfg, num_steps=4)
    reset_launch_counts()
    z8 = short(q_ema, labels, noise=noise)
    torch.cuda.synchronize()
    short_counts = counts = launch_counts()
    want = {NORM_NAME: 4 * cfg.depth}
    if counts != want:
        raise AssertionError(f"int8 4-step sample launches {counts}, expected {want}")
    with plain_kernels():
        z8_plain = short(q_ema, labels, noise=noise)
    z16 = short(state.ema, labels, noise=noise)
    torch.cuda.synchronize()
    err = ((z8 - z8_plain).abs().max() / z8_plain.abs().max()).item()
    rel = ((z8 - z16).norm() / z16.norm()).item()
    ok = err <= FEATURE_REL and rel < 0.15 and torch.isfinite(z8).all().item()
    print(f"int8 DiT-XL/1 4-step sample on {card}: launches {counts}; vs plain versions max err "
          f"{err:.3e} of max|ref| (limit {FEATURE_REL:g}); vs the bf16 sampler rel {rel:.4e} "
          f"(limit 0.15) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the int8 sampler disagrees with the plain run or the bf16 sampler")

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    images = sample_images(q_ema, tokenizer, labels, gen, latent_stats=stats,
                           num_steps=SAMPLE_STEPS, timestep_shift=0.075, cfg_scale=1.0)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {NORM_NAME: SAMPLE_STEPS * cfg.depth,
            ARM_NAME[torch.float32]: tokenizer.config.decoder_depth}
    print(f"int8 sampling: kernel launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"int8 sampling launches {counts}, expected {want}")
    if tuple(images.shape) != (SAMPLE_BATCH, tokenizer.img_size, tokenizer.img_size, 3):
        raise AssertionError(f"int8 sampled images {tuple(images.shape)}")
    print(f"sampling DiT-XL/1 int8 W8A8 {SAMPLE_BATCH} images, {SAMPLE_STEPS} euler steps, cfg "
          f"1.0, VTP-L decode on {card}: {sample_s:.3f} s ({sample_s / SAMPLE_STEPS * 1e3:.2f} ms "
          f"a step), bf16 {bf16_sample_s:.3f} s ({bf16_sample_s / SAMPLE_STEPS * 1e3:.2f} ms); "
          f"int8 / bf16 {sample_s / bf16_sample_s:.3f} (host clock, one run each)", flush=True)
    return {name: n + short_counts.get(name, 0) for name, n in counts.items()}


def check_train_kernels(gen):
    """Phase 2, training kernels: the attention backward at every call site of
    the train step plus flag cases (bf16 within 1e-2 of max|ref|, as the
    forward), and the fused CE forward and backward at the step's rows plus
    ragged cases (ce and stats within 1e-5 of max|ref|: fp32 sums of one row
    in another order; ds within 1e-2 of max|ref| in bf16, 1e-5 in fp32).
    Returns the error of each kernel at its main shape."""
    import torch

    from vtp_tpu_torch.ops import fused_ce
    from vtp_tpu_torch.ops.flash_attention import (
        fused_qkv_rope_attention_bwd,
        fused_qkv_rope_attention_bwd_reference,
    )

    errs = {}
    cases = [c + (0,) for c in TRAIN_ATTENTION] + [
        ("n_valid", 2, 197, 4, 14, 1, False, 190),
        ("causal_n_valid_rope", 2, 197, 4, 14, 1, True, 150),
        ("causal_ragged", 3, 70, 4, 0, 0, True, 0)]
    for name, B, N, H, grid, prefix, causal, n_valid in cases:
        qkv, (sin, cos), _ = _attention_inputs(gen, B, N, H, torch.bfloat16, grid, prefix)
        g = torch.randn((B, N, H * 64), generator=gen, device="cuda").bfloat16()
        got = fused_qkv_rope_attention_bwd(qkv, g, sin, cos, H, n_valid, causal)
        torch.cuda.synchronize()
        want = fused_qkv_rope_attention_bwd_reference(qkv, g, sin, cos, H, n_valid, causal)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = err <= 1e-2 * scale and torch.isfinite(got).all().item()
        print(f"kernel attention_bwd {name:20s} B={B} N={N} H={H} causal={causal} "
              f"n_valid={n_valid}: max abs err {err:.3e} (max|ref| {scale:.3e}; limit 1e-2 rel) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"attention backward {name} disagrees with its plain version")
        if name == "trunk_globals":
            errs["attention_bwd"] = err
    check_edges_bwd(gen, qk_norm=False)
    ragged = [("ragged_bf16", 5, 2051, torch.bfloat16), ("ragged_fp32", 37, 1000, torch.float32)]
    for name, R, C, dtype in [c + (torch.bfloat16,) for c in TRAIN_CE] + ragged:
        t = torch.randn((R, C), generator=gen, device="cuda").to(dtype)
        s = torch.randn((R, C), generator=gen, device="cuda").to(dtype)
        center = 0.1 * torch.randn(C, generator=gen, device="cuda")
        g = torch.rand(R, generator=gen, device="cuda")
        ce, stats = fused_ce.fused_ce_fwd(t, s, center, 0.07, 0.1)
        ds = fused_ce.fused_ce_bwd(t, s, center, g, stats, 0.07, 0.1)
        torch.cuda.synchronize()
        ce0, stats0 = fused_ce.fused_ce_fwd_reference(t, s, center, 0.07, 0.1)
        ds0 = fused_ce.fused_ce_bwd_reference(t, s, center, g, stats0, 0.07, 0.1)
        fwd_err = max((a - b).abs().max().item() / b.abs().max().item()
                      for a, b in zip((ce, *stats), (ce0, *stats0)))
        bwd_err = (ds.float() - ds0.float()).abs().max().item()
        bwd_scale = ds0.float().abs().max().item()
        bwd_tol = 1e-2 if dtype is torch.bfloat16 else 1e-5
        ok = (fwd_err <= 1e-5 and bwd_err <= bwd_tol * bwd_scale
              and torch.isfinite(ce).all().item() and torch.isfinite(ds).all().item())
        print(f"kernel fused_ce {name:14s} R={R} C={C} {str(dtype)[6:]}: fwd max rel err "
              f"{fwd_err:.3e} (limit 1e-5), bwd max abs err {bwd_err:.3e} (max|ref| "
              f"{bwd_scale:.3e}; limit {bwd_tol:g} rel) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"fused CE {name} disagrees with its plain version")
        if name == "ibot":
            errs["fused_ce_fwd"] = (ce - ce0).abs().max().item()
            errs["fused_ce_bwd"] = bwd_err
    return errs


def check_dit_kernels(gen):
    """Phase 2, DiT kernels: the forward with qk-norm at DiT-XL/1's shape, and
    the backward's qk-norm arm there and on flag cases (d(qkv) within 1e-2
    of max|ref| as the other arms; dw_q and dw_k within 1e-2 relative: fp32
    sums of the same terms in another order). Returns the error of each at
    the DiT shape."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import (
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_qk_norm_bwd,
        fused_qkv_rope_attention_qk_norm_bwd_reference,
        fused_qkv_rope_attention_reference,
    )

    B, N, H, grid = DIT_ATTENTION
    qkv, (sin, cos), (qs, ks) = _attention_inputs(gen, B, N, H, torch.bfloat16, grid, 0, True)
    got = fused_qkv_rope_attention(qkv, sin, cos, H, qs, ks)
    torch.cuda.synchronize()
    want = fused_qkv_rope_attention_reference(qkv, sin, cos, H, qs, ks)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = err <= 1e-2 * scale and torch.isfinite(got).all().item()
    print(f"kernel dit_xl_forward qk_norm bf16 B={B} N={N} H={H}: max abs err {err:.3e} "
          f"(max|ref| {scale:.3e}; limit 1e-2 rel) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("fused attention with qk-norm disagrees with its plain version")
    errs = {"bf16_qk_norm": err}
    # name, B, N, H, rope grid (0 = none), prefix, causal, n_valid
    cases = [("dit_xl", B, N, H, grid, 0, False, 0),
             ("no_rope", 2, 197, 4, 0, 0, False, 0),
             ("n_valid", 2, 197, 4, 14, 1, False, 190),
             ("causal", 2, 197, 4, 0, 0, True, 0),
             ("causal_n_valid_rope", 3, 197, 4, 14, 1, True, 150)]
    for name, B, N, H, grid, prefix, causal, n_valid in cases:
        qkv, (sin, cos), (qs, ks) = _attention_inputs(gen, B, N, H, torch.bfloat16, grid, prefix,
                                                      True)
        g = torch.randn((B, N, H * 64), generator=gen, device="cuda").bfloat16()
        got = fused_qkv_rope_attention_qk_norm_bwd(qkv, g, sin, cos, qs, ks, H, n_valid, causal)
        torch.cuda.synchronize()
        want = fused_qkv_rope_attention_qk_norm_bwd_reference(qkv, g, sin, cos, qs, ks, H,
                                                              n_valid, causal)
        err = (got[0].float() - want[0].float()).abs().max().item()
        scale = want[0].float().abs().max().item()
        dw_err = max((a - b).abs().max().item() / b.abs().max().item()
                     for a, b in zip(got[1:], want[1:]))
        ok = (err <= 1e-2 * scale and dw_err <= 1e-2
              and all(torch.isfinite(t).all().item() for t in got))
        print(f"kernel attention_bwd_qk_norm {name:20s} B={B} N={N} H={H} causal={causal} "
              f"n_valid={n_valid}: d(qkv) max abs err {err:.3e} (max|ref| {scale:.3e}; limit "
              f"1e-2 rel), dw max rel err {dw_err:.3e} (limit 1e-2) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"attention backward qk-norm {name} disagrees with its plain version")
        if name == "dit_xl":
            errs["attention_bwd_qk_norm"] = err
    check_edges_bwd(gen, qk_norm=True)
    return errs


def _flash_inputs(gen, bnhd, B, N, H, d, view=False):
    """bf16 q, k, v in the entry's layout, (B, N, H, d) or (B, H, N, d); with
    ``view``, the text path's permuted views of one (B, N, 3*H*d) qkv."""
    import torch

    if view:
        qkv = torch.randn((B, N, 3 * H * d), generator=gen, device="cuda").bfloat16()
        return qkv.reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4).unbind(0)
    shape = (B, N, H, d) if bnhd else (B, H, N, d)
    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))


def check_edges_flash():
    """The strided attention, both entries, at N in EDGE_N and head dims 32,
    64 and 128 (B = 1, H = 2), and the (B, H, N, d) entry on the text path's
    strided view of a packed qkv at N = 77, on the inputs of each of
    EDGE_SEEDS, held to 1e-2 of max|ref| against the plain versions: its
    single sweep rounds p where the plain version does not, so the margin to
    the gate is read over several draws. At N = 1 the output is v exactly."""
    import torch

    from vtp_tpu_torch.ops import flash_attention as fa

    entries = {True: (fa.flash_attention_bnhd, fa.flash_attention_bnhd_reference),
               False: (fa.flash_attention, fa.flash_attention_reference)}
    cases = [(bnhd, N, d, False) for bnhd in (True, False) for N in EDGE_N for d in (32, 64, 128)]
    cases += [(False, 77, d, True) for d in (32, 64, 128)]
    worst = {}
    for seed in EDGE_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        worst[seed] = (0.0, "")
        for bnhd, N, d, view in cases:
            kern, plain = entries[bnhd]
            q, k, v = _flash_inputs(gen, bnhd, 1, N, 2, d, view)
            with torch.no_grad():
                got = kern(q, k, v)
                torch.cuda.synchronize()
                want = plain(q, k, v)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            case = f"{'bnhd' if bnhd else 'bhnd'}{' view' if view else ''} N={N} d={d}"
            ok = err <= 1e-2 * scale and torch.isfinite(got).all().item()
            if N == 1:
                ok = ok and torch.equal(got.reshape(v.shape), v)
            if err / scale > worst[seed][0]:
                worst[seed] = (err / scale, case)
            if not ok:
                print(f"kernel edge flash seed {seed} {case}: max abs err {err:.3e} (max|ref| "
                      f"{scale:.3e}; limit 1e-2 rel{'; v exactly at N = 1' if N == 1 else ''}) "
                      f"FAIL", flush=True)
                raise AssertionError(f"strided attention edge case {case} disagrees")
    print(f"kernel edge flash, both entries, {len(cases)} cases (N in {EDGE_N}, d 32/64/128, the "
          f"text view at N = 77), each on the inputs of seeds {EDGE_SEEDS}: worst max abs err of "
          f"max|ref| (limit 1e-2; N = 1 exactly v) by seed: "
          + ", ".join(f"{sd}: {w:.3e} ({case})" for sd, (w, case) in worst.items()) + " ok",
          flush=True)


def check_flash_kernels(gen):
    """Phase 2, the strided attention without a prologue: both entries at the
    head-major trunk's and the text tower's shapes, at head dims 32 and 128
    on a small shape, and the (B, H, N, d) entry on the text path's strided
    view of its qkv GEMM output; each held to the fused bf16 arm's
    tolerance (1e-2 of max|ref|) against its plain version. Returns each
    entry's error at its main path's shape."""
    import torch

    from vtp_tpu_torch.ops import flash_attention as fa

    entries = {True: (fa.flash_attention_bnhd, fa.flash_attention_bnhd_reference,
                      fa.FLASH_BNHD_NAME),
               False: (fa.flash_attention, fa.flash_attention_reference, fa.FLASH_NAME)}
    cases = [(name, bnhd, shape, False) for bnhd in (True, False)
             for name, shape in (("trunk", FLASH_TRUNK), ("text", FLASH_TEXT),
                                 ("d32", (2, 197, 4, 32)), ("d128", (2, 197, 4, 128)))]
    cases.append(("text_qkv_view", False, FLASH_TEXT, True))
    errs = {}
    for name, bnhd, (B, N, H, d), view in cases:
        kern, plain, label = entries[bnhd]
        q, k, v = _flash_inputs(gen, bnhd, B, N, H, d, view)
        with torch.no_grad():
            got = kern(q, k, v)
            torch.cuda.synchronize()
            want = plain(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = err <= 1e-2 * scale and torch.isfinite(got).all().item()
        print(f"kernel {label} {name:14s} B={B} N={N} H={H} d={d}: max abs err {err:.3e} "
              f"(max|ref| {scale:.3e}; limit 1e-2 rel) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label} {name} disagrees with its plain version")
        if (name, bnhd) in (("trunk", True), ("text_qkv_view", False)):
            errs[label] = err
    check_edges_flash()
    return errs


def _same_state(a, b) -> bool:
    import torch

    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def run_head_major(model, images, exact_s):
    """Phase 3d: the head-major checkpoint path. The roundtrip's weights in
    the layout of a HEAD_MAJOR-way tensor-parallel run, written with
    ``save_pretrained`` (the native format) to a temporary directory and
    loaded with ``VTPModel.from_checkpoint`` (checked bit for bit); one
    encode, counted (VTP-L depth ``flash_attention_bnhd`` launches and no
    fused forward), held within 5e-2 of max|ref| to the canonical model's
    latents and to the same model on the plain versions; then the
    head-major roundtrip (encode and exact decode) timed beside the
    canonical one. Returns the launches of one head-major roundtrip."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.checkpoint import save_pretrained
    from vtp_tpu_torch.convert.to_torch import export_state_dict
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, FLASH_BNHD_NAME

    cfg = dataclasses.replace(model.config, vision_qkv_head_major=HEAD_MAJOR)
    hm = VTPModel(cfg, device="cuda")
    hm.load_numpy_state_dict(export_state_dict(model))
    key = "trunk.blocks.0.attn.qkv.weight"
    if torch.equal(hm.state_dict()[key], model.state_dict()[key]):
        raise AssertionError("the head-major model holds canonical qkv columns")
    n_bytes = sum(t.numel() * 4 for t in hm.state_dict().values())
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    if free < 2 * n_bytes:
        raise AssertionError(f"{tmp} has {free / 1e9:.1f} GB free; the checkpoint needs "
                             f"{n_bytes / 1e9:.1f} GB")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_pretrained(d, hm)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        t0 = time.perf_counter()
        loaded = VTPModel.from_checkpoint(d, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    same = loaded.config == cfg and _same_state(loaded, hm)
    print(f"head-major: native checkpoint (vision_qkv_head_major={HEAD_MAJOR}) of "
          f"{size / 1e9:.2f} GB written by save_pretrained in {save_s:.1f} s, loaded by "
          f"VTPModel.from_checkpoint in {load_s:.1f} s (warm page cache); state bit for bit "
          f"{'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("the loaded native checkpoint differs from the saved model")
    del hm

    torch.cuda.synchronize()
    reset_launch_counts()
    latents = loaded.get_reconstruction_latents(images)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {FLASH_BNHD_NAME: cfg.vision_depth}
    print(f"head-major encode: kernel launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"head-major encode launches {counts}, expected {want}")
    canon = model.get_reconstruction_latents(images)
    with plain_kernels():
        plain = loaded.get_reconstruction_latents(images)
    torch.cuda.synchronize()
    if tuple(latents.shape) != tuple(canon.shape) or latents.dtype != torch.bfloat16:
        raise AssertionError(f"head-major latents {tuple(latents.shape)} {latents.dtype}")
    errs = [((latents.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            for ref in (canon, plain)]
    ok = max(errs) <= 5e-2 and torch.isfinite(latents).all().item()
    print(f"head-major latents vs the canonical model's (fused kernel) on the same weights: "
          f"max err {errs[0]:.3e} of max|ref|; vs the plain versions: {errs[1]:.3e} "
          f"(limit 5e-2) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("head-major latents disagree with the canonical or plain run")

    reset_launch_counts()
    loaded.get_latents_decoded_images(loaded.get_reconstruction_latents(images))
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {FLASH_BNHD_NAME: cfg.vision_depth, ARM_NAME[torch.float32]: cfg.decoder_depth}
    if counts != want:
        raise AssertionError(f"head-major roundtrip launches {counts}, expected {want}")
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded.get_latents_decoded_images(loaded.get_reconstruction_latents(images))
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    hm_s = statistics.median(samples)
    print(f"roundtrip VTP-L 256px B={BATCH}, head-major trunk: {hm_s * 1e3:.2f} ms, "
          f"{BATCH / hm_s:.2f} images/s; canonical: {exact_s * 1e3:.2f} ms, "
          f"{BATCH / exact_s:.2f} images/s (host clock, median of 5 each)", flush=True)
    return counts, loaded


def run_text(gen, model):
    """Phase 3e: the non-causal CLIP text path. The VTP-L model's weights in a
    model with ``text_no_causal_mask``; one ``get_clip_text_feature`` call at
    B = TEXT_BATCH, L = 77, counted (text depth ``flash_attention``
    launches), held within 5e-2 of max|ref| to the same call on the plain
    versions, then timed (host clock, median of 5) beside the causal call
    of the canonical model. Returns the launches of one call."""
    import dataclasses

    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import FLASH_NAME

    cfg = dataclasses.replace(model.config, text_no_causal_mask=True)
    txt = VTPModel(cfg, device="cuda")
    txt.load_state_dict(model.state_dict())
    tokens = torch.randint(1, cfg.text_vocab_size - 1, (TEXT_BATCH, cfg.text_context_length),
                           generator=gen, device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    feat = txt.get_clip_text_feature(tokens)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {FLASH_NAME: cfg.text_depth}
    print(f"non-causal text: kernel launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"non-causal text launches {counts}, expected {want}")
    with plain_kernels():
        ref = txt.get_clip_text_feature(tokens)
    torch.cuda.synchronize()
    if tuple(feat.shape) != (TEXT_BATCH, cfg.text_embed_dim):
        raise AssertionError(f"text features {tuple(feat.shape)}")
    err = ((feat.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    ok = err <= 5e-2 and torch.isfinite(feat).all().item()
    print(f"non-causal text features vs the plain versions: max err {err:.3e} of max|ref| "
          f"(limit 5e-2) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("non-causal text features disagree with the plain run")
    times = {}
    for label, m in (("non-causal", txt), ("causal", model)):
        samples = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.get_clip_text_feature(tokens)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        times[label] = statistics.median(samples)
    print(f"clip text VTP-L B={TEXT_BATCH} L={cfg.text_context_length}: non-causal "
          f"{times['non-causal'] * 1e3:.2f} ms, causal {times['causal'] * 1e3:.2f} ms "
          f"(host clock, median of 5 each)", flush=True)
    return counts


def run_off_gate(gen):
    """Phase 3f: a VTP model whose head dim (72) the fused kernel does not
    take (OFF_GATE: VTP-L with the trunk and decoder OFF_GATE_WIDTH wide in
    OFF_GATE_HEADS heads, OFF_GATE_DEPTH deep; no CLIP towers), as the JAX
    package routes it: every block on the split path. One encode and exact
    decode of OFF_GATE_BATCH random 256x256 images, counted (no fused
    launch, no kernel launch at all: the split path's attention at head dim
    72 is the plain ``sdpa_reference``), its outputs checked and held to the
    same model on the plain versions at the roundtrip's gates (latents 5e-2
    of max|ref|, images 1e-3 abs)."""
    import dataclasses

    import torch

    from vtp_tpu_torch import VTPModel, vtp_large
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts

    cfg = dataclasses.replace(
        vtp_large(), train_clip=False, vision_embed_dim=OFF_GATE_WIDTH,
        vision_num_heads=OFF_GATE_HEADS, vision_depth=OFF_GATE_DEPTH,
        decoder_embed_dim=OFF_GATE_WIDTH, decoder_num_heads=OFF_GATE_HEADS,
        decoder_depth=OFF_GATE_DEPTH)
    model = VTPModel.init(cfg, gen, device="cuda")
    size = cfg.image_size
    images = torch.randn((OFF_GATE_BATCH, 3, size, size), generator=gen, device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    latents = model.get_reconstruction_latents(images)
    recon = model.get_latents_decoded_images(latents)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    print(f"off-gate roundtrip (head dim {cfg.vision_head_dim} / {cfg.decoder_head_dim}, "
          f"B={OFF_GATE_BATCH}): {run_s * 1e3:.1f} ms, first call; kernel launches {counts} "
          f"(expected none)", flush=True)
    if counts:
        raise AssertionError(f"the off-gate roundtrip launched {counts}")
    g = size // cfg.vision_patch_size
    if (tuple(latents.shape) != (OFF_GATE_BATCH, cfg.vision_feature_bottleneck, g, g)
            or tuple(recon.shape) != tuple(images.shape) or recon.dtype != torch.float32):
        raise AssertionError(f"off-gate latents {tuple(latents.shape)}, images {tuple(recon.shape)}")
    with plain_kernels():
        ref_latents = model.get_reconstruction_latents(images)
        ref_recon = model.get_latents_decoded_images(latents)
    torch.cuda.synchronize()
    lat_err = ((latents.float() - ref_latents.float()).abs().max()
               / ref_latents.float().abs().max()).item()
    img_err = (recon - ref_recon).abs().max().item()
    ok = (lat_err <= 5e-2 and img_err <= 1e-3 and torch.isfinite(latents).all().item()
          and torch.isfinite(recon).all().item())
    print(f"off-gate roundtrip vs plain versions: latents max err {lat_err:.3e} of max|ref| (limit "
          f"5e-2), images max abs err {img_err:.3e} (limit 1e-3) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the off-gate roundtrip disagrees with the plain-version run")


def _train_batch(gen, cfg):
    """B images, each a CLIP pair (the image and 77 random token ids), a
    reconstruction target (the same image, as bench.py) and its SSL crops."""
    import torch

    from vtp_tpu_torch.train.step import make_ssl_batch

    size = cfg.image_size
    images = torch.randn((BATCH, 3, size, size), generator=gen, device="cuda")
    text = torch.randint(1, cfg.text_vocab_size - 1, (BATCH, cfg.text_context_length),
                         generator=gen, device="cuda")
    ssl = make_ssl_batch(gen, BATCH, global_size=size, patch=cfg.vision_patch_size)
    return {"image": images, "text": text, "rec_image": images, "ssl": ssl}


def expected_train_launches(cfg, head_dim=64):
    """Launches per train step at remat off, every attention at
    ``head_dim``. Forward (bf16 arm): the trunk on the CLIP images, on the
    rec images and in the teacher (one launch a layer each), the student's
    two crops (two a layer), the decoder and the text tower. Backward: the
    same without the no-grad teacher. CE: DINO globals, DINO locals, iBOT."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, BWD_NAME, at_head_dim
    from vtp_tpu_torch.ops.fused_ce import BWD_NAME as CE_BWD
    from vtp_tpu_torch.ops.fused_ce import FWD_NAME as CE_FWD

    v, d, t = cfg.vision_depth, cfg.decoder_depth, cfg.text_depth
    return {at_head_dim(ARM_NAME[torch.bfloat16], head_dim): 5 * v + d + t,
            at_head_dim(BWD_NAME, head_dim): 4 * v + d + t, CE_FWD: 3, CE_BWD: 3}


def run_train(gen):
    """Phase 4: the VTP-L CLIP+SSL+rec train step, counted, against the same
    step on the plain versions, then timed."""
    import torch

    from vtp_tpu_torch import vtp_large
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state

    cfg = vtp_large()
    # the recipe bench.py measured: TrainConfig defaults (dino_out_dim 65536,
    # drop rates 0, bf16 compute) with warmup 0 and 1000 total steps
    tcfg = TrainConfig(warmup_steps=0, total_steps=1000, remat=False)
    state = init_state(cfg, tcfg, gen, device="cuda")
    batch = _train_batch(gen, cfg)
    step = build_train_step(cfg, tcfg)
    plain_state = copy.deepcopy(state)
    qkv_w = state.model.trunk.blocks[0].attn.qkv.weight.detach().clone()
    teacher_w = state.teacher["trunk"].blocks[0].attn.qkv.weight.detach().clone()
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    want = expected_train_launches(cfg)
    print(f"train step: first call {first_s:.3f} s; kernel launches per step {counts} "
          f"(expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"train step launches {counts}, expected {want}")

    with plain_kernels():
        plain_state, plain = step(plain_state, batch)
    torch.cuda.synchronize()
    del plain_state
    torch.cuda.empty_cache()
    for name in metrics:
        got, ref = metrics[name].item(), plain[name].item()
        limit = 2e-2 if name == "grad_norm" else 5e-3
        rel = abs(got - ref) / abs(ref)
        ok = rel <= limit and math.isfinite(got)
        print(f"train {name:11s} kernels {got:.6f} plain {ref:.6f} rel diff {rel:.3e} "
              f"(limit {limit:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"train step {name} disagrees with the plain-version step")
    moved = {
        "params": not torch.equal(qkv_w, state.model.trunk.blocks[0].attn.qkv.weight),
        "teacher": not torch.equal(teacher_w, state.teacher["trunk"].blocks[0].attn.qkv.weight),
        "dino_center": state.dino_center.abs().sum().item() > 0,
        "ibot_center": state.ibot_center.abs().sum().item() > 0,
    }
    print(f"train state moved: {moved}", flush=True)
    if not all(moved.values()):
        raise AssertionError(f"the train step left part of the state unchanged: {moved}")

    torch.cuda.reset_peak_memory_stats()
    samples = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    if not all(math.isfinite(v.item()) for v in metrics.values()):
        raise AssertionError(f"non-finite train metrics {metrics}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return counts, samples, peak_gb, state, batch, step


def expected_vtp_step_launches(cfg, remat, accum=VTP_ACCUM):
    """Launches of one VTP train step over ``accum`` microbatches, with the
    formula: per microbatch, the bf16 forward once a block in the no-grad
    teacher (v), the CLIP and rec trunks (2v), the student's two crops (2v),
    the decoder (d) and the text tower (t), and again for the blocks under
    grad when the policy recomputes the fused forward (remat True / "full" /
    "dots": 4v + d + t); the backward 4v + d + t; the CE 3 + 3. Drop-path
    changes the rows of each call, not the calls."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, BWD_NAME
    from vtp_tpu_torch.ops.fused_ce import BWD_NAME as CE_BWD
    from vtp_tpu_torch.ops.fused_ce import FWD_NAME as CE_FWD

    v, d, t = cfg.vision_depth, cfg.decoder_depth, cfg.text_depth
    grad = 4 * v + d + t
    recompute = remat in (True, "full", "dots")
    want = {ARM_NAME[torch.bfloat16]: accum * (v + grad + (grad if recompute else 0)),
            BWD_NAME: accum * grad, CE_FWD: 3 * accum, CE_BWD: 3 * accum}
    formula = (f"bf16 forward {accum} x (v + (4v + d + t){' x 2' if recompute else ''}), "
               f"backward {accum} x (4v + d + t), CE {accum} x 3 each; v={v} d={d} t={t}")
    return want, formula


def _stack_microbatches(micros):
    """Microbatches -> one batch whose leaves carry a leading microbatch axis."""
    import torch

    return {k: (_stack_microbatches([m[k] for m in micros]) if isinstance(micros[0][k], dict)
                else torch.stack([m[k] for m in micros])) for k in micros[0]}


def vtp_train_step(gen, card):
    """Phase 4a, step 1: the VTP-L step with accumulation, drop-path and the
    RoPE augmentation (remat on), on the kernels, counted, against the same
    step with the same draws on the plain versions; ``objective_grad_norms``
    once on each; then VTP_TIMED steps timed. Returns the launch counts."""
    import torch

    from vtp_tpu_torch import vtp_large
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state

    shift, jitter, rescale = VTP_ROPE_AUG
    cfg = vtp_large(rope_shift_coords=shift, rope_jitter_coords=jitter,
                    rope_rescale_coords=rescale)
    tcfg = TrainConfig(warmup_steps=0, total_steps=1000, accum_steps=VTP_ACCUM,
                       clip_drop_rate=VTP_DROP, ssl_drop_rate=VTP_DROP, rec_drop_rate=VTP_DROP)
    state = init_state(cfg, tcfg, gen, device="cuda")
    step = build_train_step(cfg, tcfg)
    micros = [_train_batch(gen, cfg) for _ in range(VTP_ACCUM)]
    batch = _stack_microbatches(micros)
    draws = [step.sample_draws(state, gen, m) for m in micros]
    keeps = [len(i) for i in draws[0]["ssl"]["drop"][0]]
    print(f"vtp training: VTP-L, remat {tcfg.remat}, B={VTP_ACCUM * BATCH} as {VTP_ACCUM} x "
          f"{BATCH}, drop rate {VTP_DROP} (rows kept of the global / local crops: {keeps[:2]}), "
          f"RoPE shift {shift} jitter {jitter} rescale {rescale}", flush=True)
    qkv_w = state.model.trunk.blocks[0].attn.qkv.weight.detach().clone()
    teacher_w = state.teacher["trunk"].blocks[0].attn.qkv.weight.detach().clone()

    # the plain run first, from a copy freed before the counted step
    plain_state = copy.deepcopy(state)
    with plain_kernels():
        plain_norms = step.objective_grad_norms(plain_state, micros[0], draws=draws[0])
        plain_state, plain = step(plain_state, batch, draws=draws)
    del plain_state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    norms = step.objective_grad_norms(state, micros[0], draws=draws[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, draws=draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    want, formula = expected_vtp_step_launches(cfg, tcfg.remat)
    print(f"vtp training: first step {first_s:.3f} s (host clock) on {card}; launches {counts} "
          f"(expected {want}: {formula})", flush=True)
    if counts != want:
        raise AssertionError(f"VTP training step launches {counts}, expected {want}")
    _hold_metrics("vtp training", metrics, plain,
                  {**{k: LOSS_REL for k in metrics if k.startswith("loss/")}, "grad_norm": 2e-2})
    _hold_metrics("vtp training objective", norms, plain_norms, {k: 2e-2 for k in norms})
    moved = {
        "params": not torch.equal(qkv_w, state.model.trunk.blocks[0].attn.qkv.weight),
        "teacher": not torch.equal(teacher_w, state.teacher["trunk"].blocks[0].attn.qkv.weight),
        "dino_center": state.dino_center.abs().sum().item() > 0,
        "ibot_center": state.ibot_center.abs().sum().item() > 0,
    }
    print(f"vtp training: state moved: {moved}", flush=True)
    if not all(moved.values()):
        raise AssertionError(f"the VTP training step left part of the state unchanged: {moved}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(VTP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not all(math.isfinite(v.item()) for v in metrics.values()):
        raise AssertionError(f"non-finite VTP training metrics {metrics}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(times)
    print(f"vtp training step VTP-L B={VTP_ACCUM * BATCH} as {VTP_ACCUM} x {BATCH} (remat on, "
          f"drop-path, RoPE augmentation, fp32 accumulators) on {card}: "
          f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms (host clock), median {step_s * 1e3:.1f}"
          f" ms, {VTP_ACCUM * BATCH / step_s:.2f} images/s; peak memory {peak_gb:.2f} GB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    return counts


def vtp_train_cli(card):
    """Phase 4a, step 2: ``tools/train_vtp.py``'s ``main`` in process at VTP-L
    widths cut to depth VTP_CLI_DEPTH, synthetic: VTP_CLI_STEPS steps with a
    checkpoint every VTP_CLI_CKPT, the restore checked bit for bit,
    ``--resume`` to VTP_CLI_TOTAL with ``--export_hf`` against an
    uninterrupted run (metrics bit for bit), the export loaded by
    ``VTPModel.from_checkpoint`` (latents equal to the student's). Returns the
    launch counts of the three runs."""
    import shutil
    import tempfile

    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.checkpoint import restore_train_state, train_state_tensors
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.tools import train_vtp
    from vtp_tpu_torch.train.step import TrainConfig, init_state

    n, total = VTP_CLI_STEPS, VTP_CLI_TOTAL
    args = ["--synthetic", "--preset", "vtp-large", "--depth", str(VTP_CLI_DEPTH),
            "--batch_size", str(VTP_ACCUM * BATCH), "--accum_steps", str(VTP_ACCUM),
            "--moment_dtype", "bf16", "--total_steps", str(total), "--log_every", "1",
            "--seed", str(SEED), "--device", "cuda"]
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    if free < 12e9:  # four depth-cut train states of ~1.8 GB and an export
        raise AssertionError(f"{tmp} has {free / 1e9:.1f} GB free; the CLI round trip needs 12 GB")
    with tempfile.TemporaryDirectory() as d:
        ckpt, straight = os.path.join(d, "vtp"), os.path.join(d, "vtp_straight")
        reset_launch_counts()
        t0 = time.perf_counter()
        first = train_vtp.main(args + ["--steps", str(n), "--ckpt_every", str(VTP_CLI_CKPT),
                                       "--out", ckpt])
        resumed = train_vtp.main(args + ["--steps", str(total), "--resume", "--export_hf",
                                         "--out", ckpt])
        whole = train_vtp.main(args + ["--steps", str(total), "--ckpt_every", str(total),
                                       "--out", straight])
        torch.cuda.synchronize()
        runs_s = time.perf_counter() - t0
        shutil.rmtree(straight)  # its metrics are what is held
        counts = launch_counts()
        cfg = train_vtp.load_config(train_vtp.parse_args(args))
        per_step, formula = expected_vtp_step_launches(cfg, True)
        steps = n + (total - n) + total
        want = {k: steps * v for k, v in per_step.items()}
        print(f"vtp training: tools/train_vtp.py main at depth {VTP_CLI_DEPTH}: {n} steps, "
              f"--resume to {total}, {total} uninterrupted, in {runs_s:.1f} s (host clock, "
              f"checkpoint writes included) on {card}; launches {counts} (expected {steps} steps x "
              f"({formula}) = {want})", flush=True)
        if counts != want or resumed["start_step"] != n:
            raise AssertionError(f"train_vtp launches {counts} / resumed at "
                                 f"{resumed['start_step']}")

        template = init_state(cfg, TrainConfig(moment_dtype="bf16"), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_train_state(ckpt, template, step=n)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        a, b = train_state_tensors(first["state"]), train_state_tensors(template)
        same = (a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
                and template.step == first["state"].step == n and template.optimizer.count == n)
        n_bytes = os.path.getsize(os.path.join(ckpt, f"step_{n:08d}", "train_state.safetensors"))
        print(f"vtp training: train state of {n_bytes / 1e9:.3f} GB (VTP-L at depth "
              f"{VTP_CLI_DEPTH}, bf16 moments) read into a template in {read_s:.2f} s (host "
              f"clock, warm page cache) on {card}; restored state bit for bit "
              f"{'ok' if same else 'FAIL'}", flush=True)
        del template, a, b, first
        if not same:
            raise AssertionError("the restored VTP train state differs from the saved one")
        exact = resumed["metrics"] == whole["metrics"][n:]
        for i, (got, ref) in enumerate(zip(resumed["metrics"], whole["metrics"][n:])):
            _hold_metrics(f"vtp training resumed step {n + i + 1}", got, ref,
                          {**{k: LOSS_REL for k in got if k.startswith("loss/")},
                           "grad_norm": 2e-2})
        print(f"vtp training: resumed steps {n + 1}-{total} bit-equal to the uninterrupted "
              f"run's: {exact}", flush=True)
        if not exact:
            raise AssertionError("the resumed steps differ from the uninterrupted run's")

        student = resumed["state"].model
        loaded = VTPModel.from_checkpoint(os.path.join(ckpt, "hf_export"), device="cuda")
        images = torch.randn((BATCH, 3, cfg.image_size, cfg.image_size),
                             generator=torch.Generator("cuda").manual_seed(SEED), device="cuda")
        with torch.no_grad():
            same_latents = torch.equal(loaded.get_reconstruction_latents(images),
                                       student.get_reconstruction_latents(images))
        print(f"vtp training: --export_hf read by VTPModel.from_checkpoint, latents equal to "
              f"the trained student's: {same_latents}", flush=True)
        if not same_latents:
            raise AssertionError("the exported model's latents differ from the student's")
        del resumed, whole, student, loaded
    torch.cuda.empty_cache()
    return counts


def run_vtp_training(gen, card):
    """Phase 4a: the VTP training step with accumulation, drop-path and the
    RoPE augmentation at VTP-L, then the CLI's train-state round trip.
    Returns the launch counts of the counted runs."""
    import torch

    t0 = time.perf_counter()
    totals = {}
    for run in (vtp_train_step(gen, card), vtp_train_cli(card)):
        torch.cuda.empty_cache()
        for k, n in run.items():
            totals[k] = totals.get(k, 0) + n
    print(f"vtp training: phase in {time.perf_counter() - t0:.1f} s (host clock) on {card}",
          flush=True)
    return totals


def _parallel_config(depth=None):
    """VTP-L, every tower's depth cut to ``depth`` when given."""
    from vtp_tpu_torch import vtp_large

    cfg = vtp_large()
    if depth is not None:
        cfg = cfg.replace(vision_depth=depth, text_depth=depth, decoder_depth=depth)
    return cfg


def _parallel_train_config(**kw):
    from vtp_tpu_torch.train.step import TrainConfig

    return TrainConfig(**{"warmup_steps": 0, "total_steps": 1000, "remat": False, **kw})


def _parallel_batch(cfg, batch):
    """A seeded global batch (the same on every rank): CLIP pairs, the rec
    target and the SSL crops, as ``_train_batch`` makes them."""
    import torch

    from vtp_tpu_torch.train.step import make_ssl_batch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    size = cfg.image_size
    images = torch.randn((batch, 3, size, size), generator=gen, device="cuda")
    text = torch.randint(1, cfg.text_vocab_size - 1, (batch, cfg.text_context_length),
                         generator=gen, device="cuda")
    ssl = make_ssl_batch(gen, batch, global_size=size, patch=cfg.vision_patch_size)
    return {"image": images, "text": text, "rec_image": images, "ssl": ssl}


def _hold_step(label, metrics, ref, params, ref_params, mu, ref_mu, lr):
    """A parallel step against the one-process step at the JAX gates: each
    loss within 5e-3 rel, the grad norm within 2e-2 rel; each leaf's first
    Adam moment (0.1 x the clipped gradient) within 5e-2 relative L2, its
    norm floored at 1e-3 of the whole's (the bf16 train step's gate,
    ``tests/test_torch_train_step.py``); every parameter element within atol
    1e-3 / rtol 5e-3, but for sign flips. Adam's first step moves each
    element by about ``lr`` whatever its gradient's size, so an element whose
    bf16 gradient comes out with the other sign (partial sums rounded to
    bf16 before they are added, on a rank or across ranks) moves 2 lr the
    other way. A flip must miss by at most 2 lr and have first moments of
    other signs (the update follows its own gradient), and a leaf may hold
    at most 2 E + 1 of them, E the flips it would show if each element's
    moment carried a Gaussian error of the leaf's RMS moment error (the sum
    of Phi(-|mu| / rms) over the elements either side moved; 2 for errors
    heavier than Gaussian near zero, 1 for a leaf that expects less than
    one). A leaf whose gradient is 0 by construction, as the key bias's
    under softmax, holds rounding noise whose signs flip at will, and E
    counts them so. The CPU test ``test_dit_dp_step_matches_jax`` holds the
    same rule."""
    import torch

    for name in ref:
        got, want = float(metrics[name]), float(ref[name])
        limit = 2e-2 if name == "grad_norm" else 5e-3
        rel = abs(got - want) / abs(want)
        ok = rel <= limit and math.isfinite(got)
        print(f"{label} {name:11s} parallel {got:.6f} one-process {want:.6f} rel diff "
              f"{rel:.3e} (limit {limit:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label}: {name} disagrees with the one-process step")
    total = math.sqrt(sum(m.float().square().sum().item() for m in ref_mu.values()))
    worst_mu = 0.0
    for name, want in ref_mu.items():
        got, want = mu[name].to(want.device).float(), want.float()
        rel = ((got - want).norm() / max(want.norm().item(), 1e-3 * total)).item()
        worst_mu = max(worst_mu, rel)
        if not rel <= 5e-2:
            raise AssertionError(f"{label}: the first moment of {name} is {rel:.3e} (rel L2) "
                                 f"from the one-process step's")
    worst, flipped, n_elems, shares, failed = 0.0, 0, 0, [], []
    for name, want in ref_params.items():
        got, want = params[name].to(want.device).float(), want.float()
        diff = (got - want).abs()
        bad = ~torch.isclose(got, want, atol=1e-3, rtol=5e-3)
        if name in ref_mu:  # a trained leaf: Adam's sign flips
            got_mu, want_mu = mu[name].to(want.device).float(), ref_mu[name].float()
            flips = bad & (diff <= 2 * lr + 1e-6) & (torch.sign(got_mu) != torch.sign(want_mu))
            active = (got_mu != 0) | (want_mu != 0)
            rms = (got_mu - want_mu)[active].double().square().mean().sqrt().clamp_min(1e-300)
            expected = torch.special.ndtr(-want_mu[active].double().abs() / rms).sum().item()
            n_flips = int(flips.sum())
            shares.append((n_flips / (2 * expected + 1), name, n_flips, expected))
            if n_flips > 2 * expected + 1:
                failed.append(f"{n_flips} of {want.numel()} elements of {name} flipped sign, "
                              f"more than 2 E + 1 for E = {expected:.1f}")
            flipped += n_flips
            bad &= ~flips
        if bad.any():
            failed.append(f"parameter {name} disagrees with the one-process step (max abs diff "
                          f"{diff[bad].max().item():.3e}), and not by a sign flip of its gradient")
        worst = max(worst, diff.max().item())
        n_elems += want.numel()
    top = ", ".join(f"{name} {n} of E {e:.1f}" for _, name, n, e in sorted(shares)[::-1][:3])
    print(f"{label}: first moments within {worst_mu:.3e} (rel L2, limit 5e-2); {len(ref_params)} "
          f"parameters within atol 1e-3 / rtol 5e-3 but {flipped} of {n_elems} elements "
          f"({flipped / n_elems:.2e}), whose gradients' signs differ and which moved the other "
          f"way by at most 2 lr (max abs diff {worst:.3e}); the leaves nearest their flip bound "
          f"2 E + 1: {top}", flush=True)
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed[:5]))


def parallel_one_rank(card):
    """Phase 4b-1: a world-size-1 NCCL group and a (1, 1) mesh; the VTP-L
    CLIP+SSL+rec step (B = 8) through the parallel path (the data-axis
    gradient all-reduce, tensor parallelism at tp = 1, FSDP at one shard,
    none of them short-circuited) against the same step without a mesh
    from the same state and batch. Returns its launch counts."""
    import torch

    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.parallel import fsdp
    from vtp_tpu_torch.parallel.mesh import make_mesh
    from vtp_tpu_torch.parallel.sharding import CALLS
    from vtp_tpu_torch.train.step import build_train_step, init_state

    cfg, tcfg = _parallel_config(), _parallel_train_config()
    mesh = make_mesh(1, 1, device="cuda")
    batch = _parallel_batch(cfg, BATCH)
    init = lambda **kw: init_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 3),
                                   device="cuda", **kw)
    ref_state = init()
    ref_state, ref = build_train_step(cfg, tcfg)(ref_state, batch)
    ref_params = {n: t.detach().clone() for n, t in ref_state.model.state_dict().items()}
    ref_mu = dict(ref_state.optimizer.mu)
    del ref_state
    torch.cuda.empty_cache()

    state = init(mesh=mesh)
    specs = fsdp.fsdp_state_specs(fsdp.train_state_tree(state), 1)
    fsdp.shard_state(state, mesh, specs)
    step = build_train_step(cfg, tcfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CALLS.clear()
    reset_launch_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = expected_train_launches(cfg)
    print(f"parallel one rank (NCCL, mesh 1x1, FSDP over {len(state.fsdp.dims)} leaves) on "
          f"{card}: launches {counts} (expected {want}); collectives {dict(CALLS)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (torch.cuda.max_memory_allocated)",
          flush=True)
    if counts != want:
        raise AssertionError(f"parallel one-rank step launches {counts}, expected {want}")
    if not state.fsdp.dims or CALLS.get("reduce_from_model", 0) == 0:
        raise AssertionError("the one-rank step skipped FSDP or the tensor-parallel collectives")
    layout = state.layout
    mu = {n: layout.gather(n, m) if layout.is_sharded(n, m.ndim) else m
          for n, m in state.optimizer.mu.items()}
    _hold_step("parallel one rank", metrics, ref, state.model.state_dict(), ref_params, mu,
               ref_mu, tcfg.learning_rate)
    return counts


def _gloo_rank(rank, arm, root):
    """One of two ranks sharing the card over gloo (spawned): the arm's VTP
    step from the seeded state and batch; writes its metrics, launches, peak
    memory and rank-local parameters, or which collective gloo refused."""
    import datetime

    import torch

    from vtp_tpu_torch import _build
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.parallel import sharding
    from vtp_tpu_torch.parallel.mesh import make_mesh
    from vtp_tpu_torch.parallel.multihost import init_distributed
    from vtp_tpu_torch.train.step import build_train_step, init_state

    torch.cuda.set_device(0)
    _build.load_library()  # built by the parent: loaded, not rebuilt
    init_distributed("cuda", backend="gloo", init_method=f"file://{root}/store_{arm['name']}",
                     rank=rank, world_size=2, timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    out = {"rank": rank}
    try:
        group = torch.distributed.group.WORLD
        probe = torch.ones(4, device="cuda")
        for op in arm["collectives"]:
            try:
                if op == "all_reduce":
                    torch.distributed.all_reduce(probe.clone(), group=group)
                else:
                    full = torch.empty(8, device="cuda")
                    sharding._all_gather_single(full, probe, group)
            except RuntimeError as e:
                out["refused"] = f"{op} on CUDA tensors: {str(e).splitlines()[0]}"
                return
        cfg = _parallel_config(PAR_DEPTH)
        tcfg = _parallel_train_config(**arm["train"])
        mesh = make_mesh(*arm["mesh"], device="cuda")
        state = init_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 5),
                           device="cuda", mesh=mesh)
        batch = _parallel_batch(cfg, PAR_BATCH)
        step = build_train_step(cfg, tcfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, torch.Generator(device="cuda").manual_seed(SEED + 9))
        torch.cuda.synchronize()
        out.update(seconds=time.perf_counter() - t0, launches=launch_counts(),
                   metrics={k: float(v) for k, v in metrics.items()},
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   params={n: t.detach().cpu() for n, t in state.model.state_dict().items()},
                   mu={n: t.detach().cpu() for n, t in state.optimizer.mu.items()},
                   hm=state.model.config.vision_qkv_head_major)
    finally:
        torch.save(out, os.path.join(root, f"{arm['name']}_rank{rank}.pt"))
        torch.distributed.destroy_process_group()


def _spawn(fn, nprocs, timeout, *args):
    """``fn(rank, *args)`` on ``nprocs`` spawned processes, joined against
    ``timeout`` seconds; a failing rank fails the phase, and a rank still
    running at the deadline is killed."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{fn.__name__}: the ranks ran past {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()


def parallel_two_ranks(card):
    """Phase 4b-2: two ranks time-slicing the one card over gloo, each arm
    against the one-process step of the same global batch, state and draws:
    data parallelism (2, 1) with drop_shards = 2, and head-major tensor
    parallelism (1, 2) (8 trunk heads of 64 a rank, the fused forward and
    backward on each rank). An arm whose collectives gloo refuses on CUDA
    tensors is left out and named. Returns rank 0's launch counts."""
    import tempfile

    import torch

    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, BWD_NAME
    from vtp_tpu_torch.parallel.mesh import AxisGroup
    from vtp_tpu_torch.parallel.sharding import ShardLayout
    from vtp_tpu_torch.train.step import build_train_step, init_state

    cfg = _parallel_config(PAR_DEPTH)
    print(f"parallel two ranks: VTP-L widths, every depth cut to {PAR_DEPTH} (of "
          f"{_parallel_config().vision_depth}), global B={PAR_BATCH}; two ranks share one card, "
          f"so their times are correctness runs, not speed figures", flush=True)
    arms = [{"name": "dp_2x1", "mesh": (2, 1), "collectives": ("all_reduce", "all_gather"),
             "train": {"drop_shards": 2, "ssl_drop_rate": PAR_DROP}},
            {"name": "tp_1x2_head_major", "mesh": (1, 2),
             "collectives": ("all_reduce", "all_gather"),
             "train": {"tp_head_major": 2}}]
    totals = {}
    with tempfile.TemporaryDirectory(prefix="vtp_par_") as root:
        for arm in arms:
            t0 = time.perf_counter()
            _spawn(_gloo_rank, 2, PAR_TIMEOUT_S, arm, root)
            ranks = [torch.load(os.path.join(root, f"{arm['name']}_rank{r}.pt"),
                                weights_only=False) for r in range(2)]
            if any("refused" in r for r in ranks):
                print(f"parallel {arm['name']}: LEFT OUT, gloo refused "
                      f"{next(r['refused'] for r in ranks if 'refused' in r)}", flush=True)
                continue
            for r in ranks:
                print(f"parallel {arm['name']} rank {r['rank']} on {card}: launches "
                      f"{r['launches']}, peak memory {r['peak_gb']:.2f} GB "
                      f"(torch.cuda.max_memory_allocated), step {r['seconds']:.2f} s (host "
                      f"clock, two ranks on one card: a correctness run)", flush=True)
            tcfg = _parallel_train_config(**arm["train"])
            ref_tcfg = _parallel_train_config(**{k: v for k, v in arm["train"].items()
                                                 if k != "tp_head_major"})
            state = init_state(cfg, ref_tcfg, torch.Generator(device="cuda").manual_seed(SEED + 5),
                               device="cuda")
            batch = _parallel_batch(cfg, PAR_BATCH)
            state, ref = build_train_step(cfg, ref_tcfg)(
                state, batch, torch.Generator(device="cuda").manual_seed(SEED + 9))
            ref_sd = {n: t.detach() for n, t in state.model.state_dict().items()}
            ref_mu = dict(state.optimizer.mu)
            del state
            for r in ranks:
                if arm["mesh"][1] == 1:
                    want, want_mu = ref_sd, ref_mu
                else:  # this rank's slab of the one-process (canonical) parameters
                    if r["hm"] != 2:
                        raise AssertionError(f"{arm['name']}: the trunk is not head-major")
                    layout = ShardLayout(AxisGroup("model", None, 2, r["rank"]), None,
                                         {"trunk": cfg.vision_num_heads,
                                          "pixel_decoder": cfg.decoder_num_heads,
                                          "text": cfg.text_num_heads}, {"trunk": 1})
                    cut = lambda sd: {n: (layout.slab(n, t) if layout.is_sharded(n, t.ndim)
                                          else t) for n, t in sd.items()}
                    want, want_mu = cut(ref_sd), cut(ref_mu)
                    launched = r["launches"]
                    if not (launched.get(ARM_NAME[torch.bfloat16]) and launched.get(BWD_NAME)):
                        raise AssertionError(f"{arm['name']} rank {r['rank']} launched no fused "
                                             f"forward or backward: {launched}")
                _hold_step(f"parallel {arm['name']} rank {r['rank']}", r["metrics"], ref,
                           r["params"], want, r["mu"], want_mu, tcfg.learning_rate)
            del ref_sd, ref_mu
            torch.cuda.empty_cache()
            print(f"parallel {arm['name']}: {time.perf_counter() - t0:.1f} s (host clock)",
                  flush=True)
            for k, n in ranks[0]["launches"].items():
                totals[k] = totals.get(k, 0) + n
    return totals


def parallel_serving(card):
    """Phase 4b-3: over the (1, 1) mesh at world size 1 (NCCL): ``VTPServer``
    answers encode, decode, clip_image and clip_text requests and
    ``VTPTokenizer(data_sharding=)`` encodes and decodes one batch, each
    against direct calls on an unparallelized copy of the same weights.
    Returns their launch counts."""
    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.generation import VTPTokenizer
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.parallel.mesh import make_mesh
    from vtp_tpu_torch.serve import VTPServer

    cfg = _parallel_config()
    mesh = make_mesh(1, 1, device="cuda")
    make = lambda: VTPModel.init(cfg, torch.Generator(device="cuda").manual_seed(SEED + 13),
                                 device="cuda")
    direct = make()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    g = cfg.image_size // cfg.vision_patch_size
    inputs = {"encode": torch.randn((PAR_SERVE_ROWS, 3, cfg.image_size, cfg.image_size),
                                    generator=gen, device="cuda"),
              "decode": torch.randn((PAR_SERVE_ROWS, cfg.vision_feature_bottleneck, g, g),
                                    generator=gen, device="cuda"),
              "clip_text": torch.randint(1, cfg.text_vocab_size - 1,
                                         (PAR_SERVE_ROWS, cfg.text_context_length),
                                         generator=gen, device="cuda")}
    inputs["clip_image"] = inputs["encode"]
    enc = direct.encode_dtype
    with torch.no_grad():
        want = {"encode": direct.get_reconstruction_latents(inputs["encode"]),
                "decode": direct.get_latents_decoded_images(inputs["decode"]),
                "clip_image": direct.get_clip_image_feature(inputs["encode"], True, enc),
                "clip_text": direct.get_clip_text_feature(inputs["clip_text"], True, enc)}
        tok_want = VTPTokenizer(direct, img_size=cfg.image_size).encode_images(inputs["encode"])
    del direct
    reset_launch_counts()
    model = make()
    srv = VTPServer(model, batch_size=PAR_SERVE_BATCH, max_wait_ms=5, warmup=False, mesh=mesh)
    try:
        futs = {k: srv.submit(k, v) for k, v in inputs.items()}
        got = {k: f.result(timeout=120) for k, f in futs.items()}
    finally:
        srv.shutdown()
    tok = VTPTokenizer(make(), img_size=cfg.image_size, data_sharding=mesh)
    tok_got = tok.encode_images(inputs["encode"])
    torch.cuda.synchronize()
    counts = launch_counts()
    for k, w in list(want.items()) + [("tokenizer encode", tok_want)]:
        out = (tok_got if k == "tokenizer encode" else got[k]).float().cpu()
        w = w.float().cpu()
        err = (out - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        print(f"parallel serving {k}: rel err {err:.3e} against direct calls (limit "
              f"{FEATURE_REL:g})", flush=True)
        if out.shape != w.shape or not err <= FEATURE_REL:
            raise AssertionError(f"parallel serving {k} disagrees with the direct call")
    print(f"parallel serving over the 1x1 mesh (NCCL) on {card}: launches {counts}", flush=True)
    return counts


def run_parallel(card):
    """Phase 4b: data, tensor and sequence parallelism and FSDP (see the
    module docstring). Returns the launch counts of its counted runs."""
    import tempfile

    import torch
    import torch.distributed as dist

    from vtp_tpu_torch.parallel.multihost import init_distributed

    t0 = time.perf_counter()
    totals = {}
    with tempfile.TemporaryDirectory(prefix="vtp_nccl_") as root:
        init_distributed("cuda", init_method=f"file://{root}/store", rank=0, world_size=1)
        print(f"parallel: world size 1, backend {dist.get_backend()}", flush=True)
        try:
            runs = [parallel_one_rank(card)]
            torch.cuda.empty_cache()
            runs.append(parallel_serving(card))
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    runs.append(parallel_two_ranks(card))
    for run in runs:
        for k, n in run.items():
            totals[k] = totals.get(k, 0) + n
    print(f"parallel: phase in {time.perf_counter() - t0:.1f} s (host clock) on {card}",
          flush=True)
    return totals


def expected_cp_pp_launches(cfg, kind, remat):
    """A rank's launches of one VTP step under CP or PP (``CPP_ARMS``): under
    CP the trunk and the decoder take the CP arms (no kernel), so the fused
    forward and backward run in the text tower alone (t each; the forward
    again under a recomputing policy), the CE 3 + 3; under PP each rank runs
    its depth / 2 layers on 2 microbatches of every crop, as many launches as
    the one-process step (``expected_vtp_step_launches`` at one microbatch)."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, BWD_NAME
    from vtp_tpu_torch.ops.fused_ce import BWD_NAME as CE_BWD
    from vtp_tpu_torch.ops.fused_ce import FWD_NAME as CE_FWD

    if kind == "pp":
        return expected_vtp_step_launches(cfg, remat, accum=1)[0]
    t = cfg.text_depth
    recompute = remat in (True, "full", "dots")
    return {ARM_NAME[torch.bfloat16]: t * (2 if recompute else 1), BWD_NAME: t, CE_FWD: 3,
            CE_BWD: 3}


def _ring_inputs():
    """The ring call's seeded bf16 q, k, v and cotangent, (1, N, 16, 64) with
    N = RING_TOKENS padded to the two ranks."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    n = RING_TOKENS + RING_TOKENS % 2
    return [torch.randn((1, n, RING_HEADS, RING_HEAD_DIM), generator=gen,
                       device="cuda").to(torch.bfloat16) for _ in range(4)]


def _ring_rank(rank):
    """This rank's ring attention over its half of ``_ring_inputs``' tokens,
    forward and backward: its output and gradients, peak memory, hops and
    host time."""
    import torch

    from vtp_tpu_torch.ops.ring_attention import ring_attention_local
    from vtp_tpu_torch.parallel.mesh import SEQ_AXIS, axis_group, make_cp_mesh
    from vtp_tpu_torch.parallel.sharding import CALLS

    seq = axis_group(make_cp_mesh(2, 1, device="cuda"), SEQ_AXIS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    q, k, v, cot = (t.chunk(2, 1)[rank].contiguous() for t in _ring_inputs())
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    CALLS.clear()
    t0 = time.perf_counter()
    o = ring_attention_local(q, k, v, seq, n_valid=RING_TOKENS)
    (o.float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "calls": dict(CALLS),
            "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
            "out": [t.detach().cpu() for t in (o, q.grad, k.grad, v.grad)]}


def _digests(module) -> "torch.Tensor":
    """Each tensor of ``module``'s state: its sum and its sum of squares in
    float64, stacked (two ranks whose states agree bit for bit agree here)."""
    import torch

    return torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                        for t in module.state_dict().values()])


def _gloo_cp_pp_rank(rank, root):
    """One of two ranks sharing the card over gloo (spawned): each arm of
    ``CPP_ARMS``' VTP step from the seeded state and batch (rank 0 writes its
    parameters and first moments, both ranks their metrics, launches,
    collectives, peak memory and how far their states' digests are apart),
    then the ring call (``_ring_rank``)."""
    import datetime

    import torch

    from vtp_tpu_torch import _build
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.parallel.mesh import AxisGroup, make_cp_mesh, make_pp_mesh
    from vtp_tpu_torch.parallel.multihost import init_distributed
    from vtp_tpu_torch.parallel.sharding import CALLS, _gather_dim
    from vtp_tpu_torch.train.step import build_train_step, init_state

    torch.cuda.set_device(0)
    _build.load_library()  # built by the parent: loaded, not rebuilt
    init_distributed("cuda", backend="gloo", init_method=f"file://{root}/store_cpp", rank=rank,
                     world_size=2, timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    world = AxisGroup("world", torch.distributed.group.WORLD, 2, rank)
    try:
        cfg = _parallel_config(PAR_DEPTH)
        batch = _parallel_batch(cfg, PAR_BATCH)
        for name, kind, shape, mode, train in CPP_ARMS:
            tcfg = _parallel_train_config(**train)
            mesh = (make_cp_mesh if kind == "cp" else make_pp_mesh)(*shape, device="cuda")
            state = init_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 5),
                               device="cuda", mesh=mesh, cp_mode=mode)
            step = build_train_step(cfg, tcfg, mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            CALLS.clear()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, torch.Generator(device="cuda").manual_seed(SEED + 9))
            torch.cuda.synchronize()
            out = {"rank": rank, "seconds": time.perf_counter() - t0, "launches": launch_counts(),
                   "calls": dict(CALLS), "metrics": {k: float(v) for k, v in metrics.items()},
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            both = _gather_dim(_digests(state.model)[None], world, 0)
            out["digest_rel"] = ((both[0] - both[1]).abs() / both[0].abs().clamp_min(1e-300)
                                 ).max().item()
            if rank == 0:
                out["params"] = {n: t.detach().cpu() for n, t in state.model.state_dict().items()}
                out["mu"] = {n: t.detach().cpu() for n, t in state.optimizer.mu.items()}
            torch.save(out, os.path.join(root, f"{name}_rank{rank}.pt"))
            del state, step, out
            torch.cuda.empty_cache()
        torch.save(_ring_rank(rank), os.path.join(root, f"ring_call_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def cp_pp_arms(card, root):
    """Phase 4c-1: each arm of ``CPP_ARMS`` against the one-process step of
    the same state, batch and draws at ``_hold_step``'s gates, its launches
    a rank exactly as ``expected_cp_pp_launches`` predicts, its collectives
    those of its arm, the two ranks' states equal. Returns rank 0's
    launches summed over the arms."""
    import torch

    from vtp_tpu_torch.train.step import build_train_step, init_state

    cfg = _parallel_config(PAR_DEPTH)
    tcfg = _parallel_train_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state = init_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 5),
                       device="cuda")
    state, ref = build_train_step(cfg, tcfg)(state, _parallel_batch(cfg, PAR_BATCH),
                                             torch.Generator(device="cuda").manual_seed(SEED + 9))
    torch.cuda.synchronize()
    print(f"context and pipeline parallel: the one-process step (depth {PAR_DEPTH}, B="
          f"{PAR_BATCH}) peaks at {(torch.cuda.max_memory_allocated() - held) / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated above the {held / 1e9:.2f} GB the run held "
          f"before it)", flush=True)
    ref_sd = {n: t.detach() for n, t in state.model.state_dict().items()}
    ref_mu = dict(state.optimizer.mu)
    del state
    totals = {}
    arm_calls = {"cp": {"ring": "ppermute", "ulysses": "all_to_all"}, "pp": "ppermute"}
    for name, kind, shape, mode, train in CPP_ARMS:
        ranks = [torch.load(os.path.join(root, f"{name}_rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        want = expected_cp_pp_launches(cfg, kind, train.get("remat", False))
        collective = arm_calls[kind][mode] if kind == "cp" else arm_calls[kind]
        for r in ranks:
            print(f"context and pipeline parallel {name} rank {r['rank']} on {card}: launches "
                  f"{r['launches']} (predicted {want}); collectives {r['calls']}; peak memory "
                  f"{r['peak_gb']:.2f} GB (torch.cuda.max_memory_allocated); step "
                  f"{r['seconds']:.2f} s (host clock, two ranks on one card: a correctness run); "
                  f"the ranks' state digests {r['digest_rel']:.3e} apart (rel)", flush=True)
            if r["launches"] != want:
                raise AssertionError(f"{name} rank {r['rank']}: launches {r['launches']}, "
                                     f"predicted {want}")
            other = {"ppermute", "all_to_all"} - {collective}
            if not r["calls"].get(collective) or any(r["calls"].get(c) for c in other):
                raise AssertionError(f"{name} rank {r['rank']}: collectives {r['calls']}, not "
                                     f"the {collective} of its arm")
            if not r["digest_rel"] <= 1e-6:
                raise AssertionError(f"{name}: the two ranks' states differ")
        tcfg_arm = _parallel_train_config(**train)
        _hold_step(f"context and pipeline parallel {name}", ranks[0]["metrics"], ref,
                   ranks[0]["params"], ref_sd, ranks[0]["mu"], ref_mu, tcfg_arm.learning_rate)
        for k, n in ranks[0]["launches"].items():
            totals[k] = totals.get(k, 0) + n
        del ranks
    return totals


def cp_ring_call(card, root):
    """Phase 4c-2: the ring at VTP-L's 1024^2 token count, each rank's half
    (forward and backward) gathered and held against the one-process plain
    attention of the same bf16 inputs (fp32 math; the forward within
    RING_FWD_REL of max|ref|, each gradient within RING_GRAD_REL of its
    max|ref|), the peaks beside each other."""
    import torch

    ranks = [torch.load(os.path.join(root, f"ring_call_rank{r}.pt"), weights_only=False)
             for r in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    q, k, v, cot = _ring_inputs()
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    qf, kf, vf = (t.transpose(1, 2) for t in leaves)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * RING_HEAD_DIM ** -0.5
    s = s.masked_fill(torch.arange(s.shape[-1], device="cuda") >= RING_TOKENS, float("-inf"))
    o = torch.matmul(torch.softmax(s, -1), vf).transpose(1, 2)
    (o * cot.float()).sum().backward()
    torch.cuda.synchronize()
    ref_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    want = [o.detach(), *(t.grad for t in leaves)]
    del s, qf, kf, vf
    names = ("output", "dq", "dk", "dv")
    n = q.shape[1]
    print(f"ring call (1, {n} = {RING_TOKENS} padded, {RING_HEADS}, {RING_HEAD_DIM}) bf16 over "
          f"two gloo ranks on {card}: peak memory a rank "
          f"{', '.join(f'{r['peak_gb']:.3f}' for r in ranks)} GB against {ref_peak:.3f} GB for "
          f"the one-process plain attention (torch.cuda.max_memory_allocated above what each "
          f"process held before the call, the inputs included); hops a rank "
          f"{ranks[0]['calls']}; {', '.join(f'{r['seconds']:.2f}' for r in ranks)} s a rank "
          f"(host clock, forward and backward, two ranks on one card)", flush=True)
    for i, (name, w) in enumerate(zip(names, want)):
        got = torch.cat([r["out"][i] for r in ranks], dim=1).to("cuda").float()
        err = ((got - w).abs().max() / w.abs().max()).item()
        limit = RING_FWD_REL if i == 0 else RING_GRAD_REL
        print(f"ring call {name}: {err:.3e} of max|ref| (limit {limit:g}) "
              f"{'ok' if err <= limit else 'FAIL'}", flush=True)
        if not err <= limit:
            raise AssertionError(f"ring call {name} disagrees with the plain attention")
    if any(r["calls"] != {"ppermute": 4} for r in ranks):
        raise AssertionError(f"ring call hops {ranks[0]['calls']}: expected 1 forward K/V hop, "
                             f"1 backward K/V hop and 2 dK/dV hops")


def run_cp_pp(card):
    """Phase 4c: context and pipeline parallelism (see the module
    docstring). Two spawned ranks run every arm and the ring call; a failure
    of either rank (gloo refusing a collective included) fails the phase.
    Returns rank 0's launch counts."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    cfg = _parallel_config(PAR_DEPTH)
    print(f"context and pipeline parallel: VTP-L widths, every depth cut to {PAR_DEPTH} (of "
          f"{_parallel_config().vision_depth}), global B={PAR_BATCH}; two ranks share one card "
          f"over gloo, so their times are correctness runs, not speed figures; arms "
          f"{[a[0] for a in CPP_ARMS]}; predicted launches a rank: CP "
          f"{expected_cp_pp_launches(cfg, 'cp', False)}, PP "
          f"{expected_cp_pp_launches(cfg, 'pp', False)}, PP remat full "
          f"{expected_cp_pp_launches(cfg, 'pp', 'full')}", flush=True)
    with tempfile.TemporaryDirectory(prefix="vtp_cpp_") as root:
        _spawn(_gloo_cp_pp_rank, 2, PAR_TIMEOUT_S, root)
        print(f"context and pipeline parallel: ranks done in {time.perf_counter() - t0:.1f} s",
              flush=True)
        counts = cp_pp_arms(card, root)
        torch.cuda.empty_cache()
        cp_ring_call(card, root)
    torch.cuda.empty_cache()
    print(f"context and pipeline parallel: phase in {time.perf_counter() - t0:.1f} s (host "
          f"clock) on {card}", flush=True)
    return counts


def zero3_one_rank(card):
    """Phase 4d-1 (a): a world-size-1 NCCL group and a (1, 1) mesh; the VTP-L
    CLIP+SSL+rec step (B = BATCH, remat off) on a ZeRO-3 state at one shard
    (every sharded parameter read whole through its all-gather, the saved
    ones gathered again in the backward, the gradients reduce-scattered,
    none of it short-circuited) against the same step without a mesh.
    Returns its launch counts and the reference (metrics, parameters,
    first moments) for phase (b)."""
    import torch

    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.parallel import fsdp
    from vtp_tpu_torch.parallel.mesh import make_mesh
    from vtp_tpu_torch.parallel.sharding import CALLS, gather_state_dict
    from vtp_tpu_torch.train.step import build_train_step, init_state

    cfg, tcfg = _parallel_config(), _parallel_train_config()
    batch = _parallel_batch(cfg, BATCH)
    init = lambda **kw: init_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 3),
                                   device="cuda", **kw)
    state = init()
    state, ref = build_train_step(cfg, tcfg)(state, batch)
    ref_params = {n: t.detach().clone() for n, t in state.model.state_dict().items()}
    ref_mu = dict(state.optimizer.mu)
    del state
    torch.cuda.empty_cache()
    mesh = make_mesh(1, 1, device="cuda")
    state = init(mesh=mesh)
    tree = fsdp.train_state_tree(state)
    specs = fsdp.fsdp_state_specs(tree, 1)
    fsdp.shard_state(state, mesh, specs)
    want_bytes = fsdp.sharded_bytes(tree, fsdp.held_specs(specs), {"data": 1})
    step = build_train_step(cfg, tcfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    CALLS.clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    want = expected_train_launches(cfg)
    calls = {k: v for k, v in CALLS.items() if k.startswith("fsdp")}
    print(f"zero3 one rank (NCCL, mesh 1x1, {len(state.fsdp.dims)} leaves sharded, "
          f"sharded_bytes {want_bytes / 1e9:.3f} GB) on {card}: launches {counts} (expected "
          f"{want}); collectives {calls}; peak memory "
          f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.2f} GB above the "
          f"{held / 1e9:.2f} GB held before the step (torch.cuda.max_memory_allocated); step "
          f"{seconds:.2f} s (host clock)", flush=True)
    if counts != want:
        raise AssertionError(f"zero3 one-rank step launches {counts}, expected {want}")
    if not all(calls.get(k) for k in ("fsdp_gather", "fsdp_regather", "fsdp_reduce_scatter")):
        raise AssertionError(f"the one-rank ZeRO-3 step skipped its gathers: {calls}")
    layout = state.layout
    params = gather_state_dict(state.model)
    mu = {n: layout.gather(n, m) if layout.is_sharded(n, m.ndim) else m
          for n, m in state.optimizer.mu.items()}
    _hold_step("zero3 one rank", metrics, ref, params, ref_params, mu, ref_mu,
               tcfg.learning_rate)
    return counts, (ref, ref_params, ref_mu)


def _whole_weight_servers(cfg, mesh, rank=0):
    """The int8 server (``quantize_for_serving`` of every tower) and the
    fused-``w12`` server (``fuse_ffn_params``) of the seeded model at ``cfg``,
    over ``mesh`` (None: without one), each on a fresh model (the transforms
    share the untouched modules, which ``parallelize_model`` cuts): for the
    same PAR_SERVE_ROWS rows a kind, rank 0's results, and each server's
    launches and collectives."""
    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.parallel.sharding import CALLS
    from vtp_tpu_torch.serve import VTPServer
    from vtp_tpu_torch.utils.params import fuse_ffn_params

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    g = cfg.image_size // cfg.vision_patch_size
    inputs = {"encode": torch.randn((PAR_SERVE_ROWS, 3, cfg.image_size, cfg.image_size),
                                    generator=gen, device="cuda"),
              "decode": torch.randn((PAR_SERVE_ROWS, cfg.vision_feature_bottleneck, g, g),
                                    generator=gen, device="cuda"),
              "clip_text": torch.randint(1, cfg.text_vocab_size - 1,
                                         (PAR_SERVE_ROWS, cfg.text_context_length),
                                         generator=gen, device="cuda")}
    inputs["clip_image"] = inputs["encode"]
    out = {}
    for kind in ("int8", "fused"):
        model = VTPModel.init(cfg, torch.Generator(device="cuda").manual_seed(SEED + 13),
                              device="cuda")
        model = (model.quantize_for_serving(("trunk", "text", "pixel_decoder"))
                 if kind == "int8" else fuse_ffn_params(model))
        reset_launch_counts()
        CALLS.clear()
        srv = VTPServer(model, batch_size=PAR_SERVE_BATCH, max_wait_ms=5, warmup=False,
                        mesh=mesh)
        try:
            if rank == 0:
                futs = {k: srv.submit(k, v) for k, v in inputs.items()}
                res = {k: f.result(timeout=120).cpu() for k, f in futs.items()}
        finally:
            srv.shutdown()
        torch.cuda.synchronize()
        out[kind] = {"launches": launch_counts(), "calls": dict(CALLS)}
        if rank == 0:
            out[kind]["results"] = res
        del model, srv
        torch.cuda.empty_cache()
    return out


def _hold_whole_weight_servers(label, got, want, card):
    """The int8 server's results bit for bit, the fused server's within
    ``run_serve``'s gates (decode 1e-4, the bf16 kinds FEATURE_REL, of
    max|ref|), each against the same server without a mesh; every server
    launched the bf16 fused forward. Returns the launches summed."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import ARM_NAME

    totals = {}
    for kind in ("int8", "fused"):
        g, w = got[kind], want[kind]
        print(f"{label} {kind} server on {card}: launches {g['launches']}, collectives "
              f"{g['calls']}", flush=True)
        if not g["launches"].get(ARM_NAME[torch.bfloat16]):
            raise AssertionError(f"{label} {kind}: the server launched no fused forward")
        for k, ref in w["results"].items():
            out = g["results"][k]
            if kind == "int8":
                ok = out.shape == ref.shape and torch.equal(out, ref)
                print(f"{label} int8 {k}: {'bit-equal' if ok else 'DIFFERS from'} the server "
                      f"without a mesh", flush=True)
            else:
                limit = 1e-4 if k == "decode" else FEATURE_REL
                err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
                ok = out.shape == ref.shape and err <= limit
                print(f"{label} fused {k}: {err:.3e} of max|ref| from the server without a "
                      f"mesh (limit {limit:g}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{label} {kind} {k} disagrees with the server without "
                                     f"a mesh")
        for n, c in g["launches"].items():
            totals[n] = totals.get(n, 0) + c
    return totals


def _state_digest(tensors, world) -> float:
    """How far apart (rel) the two ranks' float64 sums and sums of squares
    of ``tensors`` are: 0 when their states agree bit for bit."""
    import torch

    from vtp_tpu_torch.parallel.sharding import _gather_dim

    d = torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                     for t in tensors])
    both = _gather_dim(d[None], world, 0)
    return ((both[0] - both[1:]).abs() / both[0].abs().clamp_min(1e-300)).max().item()


def _zero3_gloo_rank(rank, root):
    """One of two ranks sharing the card over gloo (spawned). (b): the full
    VTP-L ZeRO-3 state over (data 2, model 1), its bytes after
    ``shard_state`` against ``sharded_bytes``, one step (B = ZERO3_BATCH,
    remat off), its launches, collectives, peak and time, the gathered
    state's digest against the other rank's (rank 0 writes the gathered
    parameters and first moments). (d): the int8 and fused-w12 servers over
    (1, 2) at depth PAR_DEPTH."""
    import datetime

    import torch

    from vtp_tpu_torch import _build
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.parallel import fsdp
    from vtp_tpu_torch.parallel.mesh import AxisGroup, make_mesh
    from vtp_tpu_torch.parallel.multihost import init_distributed
    from vtp_tpu_torch.parallel.sharding import CALLS, gather_state_dict
    from vtp_tpu_torch.train.step import build_train_step, init_state

    torch.cuda.set_device(0)
    _build.load_library()  # built by the parent: loaded, not rebuilt
    init_distributed("cuda", backend="gloo", init_method=f"file://{root}/store_zero3",
                     rank=rank, world_size=2,
                     timeout=datetime.timedelta(seconds=ZERO3_TIMEOUT_S))
    world = AxisGroup("world", torch.distributed.group.WORLD, 2, rank)
    try:
        cfg, tcfg = _parallel_config(), _parallel_train_config()
        mesh = make_mesh(2, 1, device="cuda")
        state = init_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 3),
                           device="cuda", mesh=mesh)
        tree = fsdp.train_state_tree(state)  # holds the whole leaves it did not cut
        specs = fsdp.fsdp_state_specs(tree, 2)
        out = {"rank": rank,
               "want": fsdp.sharded_bytes(tree, fsdp.held_specs(specs), {"data": 2}),
               "replicated": fsdp.sharded_bytes(tree, fsdp.fsdp_state_specs(tree, 1),
                                                {"data": 1})}
        del tree
        fsdp.shard_state(state, mesh, specs)
        torch.cuda.synchronize()
        out["held"] = torch.cuda.memory_allocated()
        out["requested"] = torch.cuda.memory_stats()["requested_bytes.all.current"]
        batch = _parallel_batch(cfg, ZERO3_BATCH)
        step = build_train_step(cfg, tcfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_launch_counts()
        CALLS.clear()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        out.update(seconds=time.perf_counter() - t0, launches=launch_counts(),
                   calls={k: v for k, v in CALLS.items() if k.startswith("fsdp")},
                   metrics={k: float(v) for k, v in metrics.items()}, before=before,
                   peak=torch.cuda.max_memory_allocated())
        del batch, step
        layout = state.layout
        params = gather_state_dict(state.model)
        mu = {n: layout.gather(n, m) if layout.is_sharded(n, m.ndim) else m
              for n, m in state.optimizer.mu.items()}
        out["digest_rel"] = _state_digest([*params.values(), *mu.values()], world)
        if rank == 0:
            out["params"] = {n: t.cpu() for n, t in params.items()}
            out["mu"] = {n: t.cpu() for n, t in mu.items()}
        del params, mu, state
        torch.cuda.empty_cache()
        out["serve"] = _whole_weight_servers(_parallel_config(PAR_DEPTH),
                                             make_mesh(1, 2, device="cuda"), rank)
        torch.save(out, os.path.join(root, f"zero3_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _zero3_tp_rank(rank, root):
    """One of four ranks sharing the card over gloo (spawned), (c): the
    VTP-L step at depth PAR_DEPTH (B = PAR_BATCH, remat off) on a ZeRO-3
    state over (data 2, model 2) with the trunk head-major, its bytes after
    ``shard_state``, launches, collectives, peak, time and the gathered
    state's digests (rank 0 writes the gathered parameters and first
    moments, in the stored head-major layout)."""
    import datetime

    import torch

    from vtp_tpu_torch import _build
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.parallel import fsdp
    from vtp_tpu_torch.parallel.mesh import AxisGroup, make_mesh
    from vtp_tpu_torch.parallel.multihost import init_distributed
    from vtp_tpu_torch.parallel.sharding import CALLS, gather_state_dict
    from vtp_tpu_torch.train.step import build_train_step, init_state

    torch.cuda.set_device(0)
    _build.load_library()
    init_distributed("cuda", backend="gloo", init_method=f"file://{root}/store_zero3_tp",
                     rank=rank, world_size=4,
                     timeout=datetime.timedelta(seconds=ZERO3_TIMEOUT_S))
    world = AxisGroup("world", torch.distributed.group.WORLD, 4, rank)
    try:
        cfg = _parallel_config(PAR_DEPTH)
        tcfg = _parallel_train_config(tp_head_major=2)
        mesh = make_mesh(2, 2, device="cuda")
        state = init_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 5),
                           device="cuda", mesh=mesh)
        tree = fsdp.train_state_tree(state)
        specs = fsdp.fsdp_state_specs(tree, 2, tensor_parallel=True)
        fsdp.shard_state(state, mesh, specs)
        sizes = {"data": 2, "model": 2}
        out = {"rank": rank, "want": fsdp.sharded_bytes(tree, fsdp.held_specs(specs), sizes),
               "jax_rule": fsdp.sharded_bytes(tree, specs, sizes),
               "held": sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                            for t in [*state.optimizer.leaves.values(),
                                      *state.optimizer.mu.values(),
                                      *state.optimizer.nu.values(),
                                      *state.teacher.state_dict().values(),
                                      state.dino_center, state.ibot_center]}.values())}
        del tree
        batch = _parallel_batch(cfg, PAR_BATCH)
        step = build_train_step(cfg, tcfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        CALLS.clear()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, torch.Generator(device="cuda").manual_seed(SEED + 9))
        torch.cuda.synchronize()
        out.update(seconds=time.perf_counter() - t0, launches=launch_counts(),
                   calls={k: v for k, v in CALLS.items()
                          if k.startswith("fsdp") or k == "reduce_from_model"},
                   metrics={k: float(v) for k, v in metrics.items()},
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   hm=state.model.config.vision_qkv_head_major)
        layout = state.layout
        params = gather_state_dict(state.model)
        mu = {n: layout.gather(n, m) if layout.is_sharded(n, m.ndim) else m
              for n, m in state.optimizer.mu.items()}
        out["digest_rel"] = _state_digest([*params.values(), *mu.values()], world)
        if rank == 0:
            out["params"] = {n: t.cpu() for n, t in params.items()}
            out["mu"] = {n: t.cpu() for n, t in mu.items()}
        torch.save(out, os.path.join(root, f"zero3_tp_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def zero3_two_ranks(card, root, ref):
    """Phase 4d-2 (b), read: each rank's requested bytes after ``shard_state``
    against ``sharded_bytes`` (within ZERO3_BYTES_SLACK), its launches
    (exactly ``expected_train_launches``), collectives, peak and time; the
    two ranks' gathered states equal; rank 0's against the one-process step
    of phase (a) at ``_hold_step``'s gates. Returns rank 0's launches."""
    import torch

    cfg, tcfg = _parallel_config(), _parallel_train_config()
    ranks = [torch.load(os.path.join(root, f"zero3_rank{r}.pt"), weights_only=False)
             for r in range(2)]
    want = expected_train_launches(cfg)
    for r in ranks:
        diff = r["requested"] - r["want"]
        print(f"zero3 (2, 1) full VTP-L rank {r['rank']} on {card}: after shard_state the "
              f"allocator holds {r['requested']} B requested ({r['held']} B in its blocks, "
              f"torch.cuda.memory_allocated) against sharded_bytes {r['want']} B (JAX's rule; "
              f"{diff:+d} B; replicated {r['replicated']} B); step peak "
              f"{r['peak'] / 1e9:.2f} GB, {(r['peak'] - r['before']) / 1e9:.2f} GB above the "
              f"{r['before'] / 1e9:.2f} GB held with the batch (torch.cuda.max_memory_allocated); "
              f"launches {r['launches']} (expected {want}); collectives {r['calls']}; step "
              f"{r['seconds']:.2f} s (host clock, two ranks on one card over gloo: a "
              f"correctness run); gathered states {r['digest_rel']:.3e} apart (rel)", flush=True)
        if not abs(diff) <= ZERO3_BYTES_SLACK:
            raise AssertionError(f"zero3 rank {r['rank']} holds {r['requested']} B, "
                                 f"sharded_bytes says {r['want']} B")
        if r["launches"] != want:
            raise AssertionError(f"zero3 rank {r['rank']}: launches {r['launches']}, expected "
                                 f"{want}")
        if not all(r["calls"].get(k) for k in ("fsdp_gather", "fsdp_regather",
                                               "fsdp_reduce_scatter")):
            raise AssertionError(f"zero3 rank {r['rank']} skipped its gathers: {r['calls']}")
        if r["digest_rel"] != 0.0:
            raise AssertionError("the two ZeRO-3 ranks' gathered states differ")
    metrics, ref_params, ref_mu = ref
    _hold_step("zero3 (2, 1) full VTP-L", ranks[0]["metrics"], metrics, ranks[0]["params"],
               ref_params, ranks[0]["mu"], ref_mu, tcfg.learning_rate)
    return ranks[0]["launches"], [r["serve"] for r in ranks]


def zero3_tp_ranks(card, root):
    """Phase 4d-3 (c), read: each of the four ranks' held bytes (storages)
    equal to ``sharded_bytes`` of ``held_specs``, launches exactly
    ``expected_train_launches`` at depth PAR_DEPTH, its gathers and the
    Megatron pair run, the ranks' gathered states equal; rank 0's, its trunk
    permuted back to canonical, against the one-process step at depth
    PAR_DEPTH at ``_hold_step``'s gates. Returns rank 0's launches."""
    import torch

    from vtp_tpu_torch.parallel.sharding import permute_qkv_state_dict
    from vtp_tpu_torch.train.step import build_train_step, init_state

    cfg, tcfg = _parallel_config(PAR_DEPTH), _parallel_train_config()
    state = init_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(SEED + 5),
                       device="cuda")
    state, ref = build_train_step(cfg, tcfg)(state, _parallel_batch(cfg, PAR_BATCH),
                                             torch.Generator(device="cuda").manual_seed(SEED + 9))
    ref_sd = {n: t.detach() for n, t in state.model.state_dict().items()}
    ref_mu = dict(state.optimizer.mu)
    del state
    ranks = [torch.load(os.path.join(root, f"zero3_tp_rank{r}.pt"), weights_only=False)
             for r in range(4)]
    want = expected_train_launches(cfg)
    for r in ranks:
        print(f"zero3 x tp (2, 2) head-major VTP-L depth {PAR_DEPTH} rank {r['rank']} on {card}: "
              f"held {r['held']} B, sharded_bytes {r['want']} B (the moments cut as their "
              f"parameters; JAX's rule {r['jax_rule']} B); launches {r['launches']} (expected "
              f"{want}); collectives {r['calls']}; peak {r['peak_gb']:.2f} GB; step "
              f"{r['seconds']:.2f} s (host clock, four ranks on one card over gloo); gathered "
              f"states {r['digest_rel']:.3e} apart (rel)", flush=True)
        if r["held"] != r["want"] or r["launches"] != want or r["hm"] != 2:
            raise AssertionError(f"zero3 x tp rank {r['rank']}: held {r['held']} / "
                                 f"{r['want']} B, launches {r['launches']}, layout {r['hm']}")
        if not all(r["calls"].get(k) for k in ("fsdp_gather", "fsdp_regather",
                                               "fsdp_reduce_scatter", "reduce_from_model")):
            raise AssertionError(f"zero3 x tp rank {r['rank']}: collectives {r['calls']}")
        if r["digest_rel"] != 0.0:
            raise AssertionError("the four ZeRO-3 x TP ranks' gathered states differ")
    heads = cfg.vision_num_heads
    canonical = lambda sd: permute_qkv_state_dict(sd, heads, 2, inverse=True)
    _hold_step(f"zero3 x tp (2, 2) depth {PAR_DEPTH}", ranks[0]["metrics"], ref,
               canonical(ranks[0]["params"]), ref_sd, canonical(ranks[0]["mu"]), ref_mu,
               tcfg.learning_rate)
    return ranks[0]["launches"]


def run_parity_probe(card):
    """Phase 4d-5 (e): ``python -m vtp_tpu_torch.tools.parity_probe --presets
    PROBE_PRESETS`` as a subprocess (each preset in its own process, with a
    timeout); its exit code must be 0. Prints its deltas beside the JAX
    package's round-5 rows, which are TPU figures."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="vtp_probe_") as root:
        path = os.path.join(root, "probe.json")
        cmd = [sys.executable, "-u", "-m", "vtp_tpu_torch.tools.parity_probe", "--presets",
               ",".join(PROBE_PRESETS), "--json", path, "--timeout", str(PROBE_PRESET_TIMEOUT_S)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=PROBE_PRESET_TIMEOUT_S * len(PROBE_PRESETS) + 60)
        seconds = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            if line.startswith(("== preset", "kernel arm", "fallback arm", "PARITY")):
                print(f"parity probe: {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", flush=True)
            raise AssertionError(f"the parity probe exited {proc.returncode}")
        with open(path) as f:
            result = json.load(f)
    for r in result["probes"]:
        tpu = JAX_PROBE_R5[r["preset"]]
        d = r["deltas"]
        print(f"parity probe {r['preset']} (B={r['batch']}) on {card}: encode rel "
              f"{d['latents']['max_rel']:.2e}, clip image {d['clip_image']['max_rel']:.2e}, clip "
              f"text {d['clip_text']['max_rel']:.2e}, decode {d['decode']['max_rel']:.2e}, "
              f"loss/total rel {r['loss_rel']['loss/total']:.2e}, grad-norm rel "
              f"{r['grad_norm_rel']:.2e}; the JAX package's round-5 row (a TPU v5e, not this "
              f"card): encode {tpu[0]:.1e}, decode {tpu[1]:.1e}, loss/total {tpu[2]:.1e}, "
              f"grad norm {tpu[3]:.1e}", flush=True)
    print(f"parity probe: {seconds:.1f} s (host clock, one fresh process a preset)", flush=True)


def run_zero3(card):
    """Phase 4d: ZeRO-3 FSDP, tensor parallelism over int8 and fused-w12
    weights, the parity probe (see the module docstring). Returns the
    launch counts of its counted runs."""
    import tempfile

    import torch
    import torch.distributed as dist

    from vtp_tpu_torch.parallel.mesh import make_mesh
    from vtp_tpu_torch.parallel.multihost import init_distributed

    t0 = time.perf_counter()
    totals = {}

    def add(run):
        for k, n in run.items():
            totals[k] = totals.get(k, 0) + n

    with tempfile.TemporaryDirectory(prefix="vtp_zero3_") as root:
        init_distributed("cuda", init_method=f"file://{root}/store", rank=0, world_size=1)
        try:
            counts, ref = zero3_one_rank(card)
            add(counts)
            torch.cuda.empty_cache()
            full = _parallel_config()
            nccl = _whole_weight_servers(full, make_mesh(1, 1, device="cuda"))
        finally:
            dist.destroy_process_group()
        add(_hold_whole_weight_servers("zero3 phase (1, 1) NCCL full VTP-L", nccl,
                                       _whole_weight_servers(full, None), card))
        del nccl
        torch.cuda.empty_cache()
        print(f"zero3: (a) and the (1, 1) servers in {time.perf_counter() - t0:.1f} s",
              flush=True)
        t1 = time.perf_counter()
        _spawn(_zero3_gloo_rank, 2, ZERO3_TIMEOUT_S, root)
        print(f"zero3: the two gloo ranks (b, d) in {time.perf_counter() - t1:.1f} s",
              flush=True)
        counts, served = zero3_two_ranks(card, root, ref)
        add(counts)
        del ref
        torch.cuda.empty_cache()
        add(_hold_whole_weight_servers(f"zero3 phase (1, 2) gloo VTP-L depth {PAR_DEPTH}",
                                       served[0], _whole_weight_servers(
                                           _parallel_config(PAR_DEPTH), None), card))
        if any(s[k]["calls"].get("reduce_from_model", 0) == 0 for s in served
               for k in ("int8", "fused")):
            raise AssertionError("a (1, 2) server ran no model collective")
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        _spawn(_zero3_tp_rank, 4, ZERO3_TIMEOUT_S, root)
        print(f"zero3: the four gloo ranks (c) in {time.perf_counter() - t1:.1f} s", flush=True)
        add(zero3_tp_ranks(card, root))
    torch.cuda.empty_cache()
    run_parity_probe(card)
    print(f"zero3, int8 tp, probe: phase in {time.perf_counter() - t0:.1f} s (host clock) on "
          f"{card}", flush=True)
    return totals


def time_tp_kernels(gen, card):
    """Phase 7, the fused attention at the tensor-parallel ranks' shapes
    (``TP_FWD_SHAPES``, ``TP_BWD_SHAPES``): bf16 forward and backward against
    their plain versions and SDPA on split, pre-roped q/k/v, with the byte
    bound. Printed lines; the kernels' JSON rows stay at the full-head shapes."""
    import torch
    import torch.nn.functional as F

    from vtp_tpu_torch.ops.flash_attention import (
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_bwd,
        fused_qkv_rope_attention_bwd_reference,
        fused_qkv_rope_attention_reference,
    )
    from vtp_tpu_torch.ops.rope import rope_apply

    bw, bf16_peak, _ = next((v for k, v in PEAKS.items() if k in card), PEAKS["H100"])
    for part, shapes in (("fwd", TP_FWD_SHAPES), ("bwd", TP_BWD_SHAPES)):
        for B, N, H, d in shapes:
            qkv, (sin, cos), _ = _attention_inputs(gen, B, N, H, torch.bfloat16, 16, 1)
            q, k, v = qkv.reshape(B, N, 3, H, d).unbind(2)
            s, c = sin[None, :, None, :], cos[None, :, None, :]
            q, k = rope_apply(q, s, c), rope_apply(k, s, c)
            q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            if part == "fwd":
                kern = lambda: fused_qkv_rope_attention(qkv, sin, cos, H)
                plain = lambda: fused_qkv_rope_attention_reference(qkv, sin, cos, H)
                lib = lambda: F.scaled_dot_product_attention(q, k, v)
                nbytes, flops = B * N * 4 * H * d * 2, 4 * B * H * N * N * d
            else:
                g = torch.randn((B, N, H * d), generator=gen, device="cuda").bfloat16()
                kern = lambda: fused_qkv_rope_attention_bwd(qkv, g, sin, cos, H, 0, False)
                plain = lambda: fused_qkv_rope_attention_bwd_reference(qkv, g, sin, cos, H, 0,
                                                                       False)
                qg, kg, vg = (x.requires_grad_() for x in (q, k, v))
                gt = g.reshape(B, N, H, d).transpose(1, 2).contiguous()

                def lib():
                    out = F.scaled_dot_product_attention(qg, kg, vg)
                    torch.autograd.grad(out, (qg, kg, vg), gt)

                nbytes, flops = B * N * 7 * H * d * 2, 10 * B * H * N * N * d
            tm = _timings(kern, plain, lib)
            t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
            print(f"timing attention_{part} tensor-parallel rank shape B={B} N={N} H={H} d={d} "
                  f"on {card}: {_fmt_times(tm, 'sdpa' if part == 'fwd' else 'sdpa fwd+bwd')}, "
                  f"bound {max(t_bytes, t_ops):.4f} ms by "
                  f"{'bytes' if t_bytes >= t_ops else 'operations'} ({nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.3f} GFLOP)", flush=True)


def dit_latents(gen, model):
    """DIT_BATCH latents from ``VTPTokenizer.encode_images`` of seeded random
    images on the VTP-L model, normalised by their per-channel statistics,
    and those statistics (mean, std), each (1, C, 1, 1)."""
    import torch

    from vtp_tpu_torch.generation import VTPTokenizer

    tokenizer = VTPTokenizer(model, img_size=model.config.image_size)
    size = model.config.image_size
    images = torch.randn((DIT_BATCH, 3, size, size), generator=gen, device="cuda")
    z = tokenizer.encode_images(images)
    mean = z.mean((0, 2, 3), keepdim=True)
    std = z.std((0, 2, 3), keepdim=True)
    return tokenizer, (z - mean) / std, (mean, std)


def expected_dit_launches(cfg):
    """Launches per DiT train step at remat on: the forward's qk-norm arm
    once a block in the forward and again in the backward's recompute, and
    the backward's qk-norm arm once a block."""
    from vtp_tpu_torch.ops.flash_attention import NORM_BWD_NAME, NORM_NAME

    return {NORM_NAME: 2 * cfg.depth, NORM_BWD_NAME: cfg.depth}


def run_dit_train(gen, latents):
    """Phase 5: the DiT-XL/1 train step, counted, against the same step on the
    plain versions, then timed."""
    import torch

    from vtp_tpu_torch.dit.model import make_dit_config
    from vtp_tpu_torch.dit.train import DiTTrainConfig, build_dit_train_step, init_dit_state
    from vtp_tpu_torch.models.initializers import normal_
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts

    cfg = make_dit_config("DiT-XL/1")
    # DiTTrainConfig defaults (bf16 compute, remat on, accum_steps 1, lr 2e-4
    # constant, EMA 0.9999) with 1000 total steps
    tcfg = DiTTrainConfig(total_steps=1000)
    state = init_dit_state(cfg, tcfg, gen, device="cuda")
    model = state.model
    with torch.no_grad():
        for lin in [b.ada for b in model.blocks] + [model.final.ada, model.final.proj]:
            normal_(lin.weight, 0.02, gen)
            normal_(lin.bias, 0.02, gen)
        state.ema.load_state_dict(model.state_dict())
    print("dit: adaLN-zero leaves (every block's ada, final.ada, final.proj) re-drawn from "
          "N(0, 0.02^2): a fresh DiT predicts 0 and passes its attention no gradient", flush=True)
    n_params = sum(p.numel() for p in model.parameters())
    labels = torch.randint(0, cfg.num_classes, (DIT_BATCH,), generator=gen, device="cuda")
    draws = {"drop": torch.rand(DIT_BATCH, generator=gen, device="cuda") < tcfg.class_dropout_prob,
             "t": torch.sigmoid(tcfg.lognorm_mu + tcfg.lognorm_sigma
                                * torch.randn(DIT_BATCH, generator=gen, device="cuda")),
             "x0": torch.randn(latents.shape, generator=gen, device="cuda")}
    step = build_dit_train_step(cfg, tcfg)
    plain_state = copy.deepcopy(state)
    qkv_w = model.blocks[0].attn.qkv.weight.detach().clone()
    ema_w = state.ema.blocks[0].attn.qkv.weight.detach().clone()
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, latents, labels, gen, draws)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    want = expected_dit_launches(cfg)
    print(f"dit train step ({n_params / 1e6:.1f} M parameters): first call {first_s:.3f} s; "
          f"kernel launches per step {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"DiT train step launches {counts}, expected {want}")

    with plain_kernels():
        plain_state, plain = step(plain_state, latents, labels, gen, draws)
    torch.cuda.synchronize()
    del plain_state
    torch.cuda.empty_cache()
    for name in metrics:
        got, ref = metrics[name].item(), plain[name].item()
        limit = 2e-2 if name == "grad_norm" else 5e-3
        rel = abs(got - ref) / abs(ref)
        ok = rel <= limit and math.isfinite(got)
        print(f"dit train {name:14s} kernels {got:.6f} plain {ref:.6f} rel diff {rel:.3e} "
              f"(limit {limit:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"DiT train step {name} disagrees with the plain-version step")
    moved = {"params": not torch.equal(qkv_w, model.blocks[0].attn.qkv.weight),
             "ema": not torch.equal(ema_w, state.ema.blocks[0].attn.qkv.weight)}
    print(f"dit train state moved: {moved}", flush=True)
    if not all(moved.values()):
        raise AssertionError(f"the DiT train step left part of the state unchanged: {moved}")

    torch.cuda.reset_peak_memory_stats()
    samples = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, latents, labels, gen, draws)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    if not all(math.isfinite(v.item()) for v in metrics.values()):
        raise AssertionError(f"non-finite DiT train metrics {metrics}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return counts, samples, peak_gb, state, labels, draws, step


def run_sampling(gen, state, tokenizer, stats):
    """Phase 6: sample_images at 250 euler steps (shift 0.075, cfg 1.0) with
    the EMA weights for SAMPLE_BATCH labels, decoded by the VTP-L tokenizer;
    counted and timed. Then a 4-step sample from the same noise on the
    kernels and on the plain versions."""
    import torch

    from vtp_tpu_torch.dit.sample import make_sampler, sample_images
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, NORM_NAME

    cfg = state.ema.config
    labels = torch.arange(SAMPLE_BATCH, device="cuda") * (cfg.num_classes // SAMPLE_BATCH)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    images = sample_images(state.ema, tokenizer, labels, gen, latent_stats=stats,
                           num_steps=SAMPLE_STEPS, timestep_shift=0.075, cfg_scale=1.0)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {NORM_NAME: SAMPLE_STEPS * cfg.depth,
            ARM_NAME[torch.float32]: tokenizer.config.decoder_depth}
    print(f"sampling: kernel launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"sampling launches {counts}, expected {want}")
    size = tokenizer.img_size
    if (tuple(images.shape) != (SAMPLE_BATCH, size, size, 3) or images.dtype != torch.uint8
            or images.device.type != "cuda"):
        raise AssertionError(f"images {tuple(images.shape)} {images.dtype} {images.device}")
    spread = images.float().std().item()
    print(f"sampling: uint8 images {tuple(images.shape)}, pixel std {spread:.2f}", flush=True)
    if not spread > 0:
        raise AssertionError("the sampled images are constant")

    shape = (SAMPLE_BATCH, cfg.in_channels, cfg.input_size, cfg.input_size)
    noise = torch.randn(shape, generator=gen, device="cuda")
    short = make_sampler(cfg, num_steps=4)
    z = short(state.ema, labels, noise=noise)
    with plain_kernels():
        z_ref = short(state.ema, labels, noise=noise)
    torch.cuda.synchronize()
    err = ((z - z_ref).abs().max() / z_ref.abs().max()).item()
    ok = err <= 5e-2 and torch.isfinite(z).all().item()
    print(f"sampling 4 steps vs plain versions: latents max err {err:.3e} of max|ref| "
          f"(limit 5e-2) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the sampler's latents disagree with the plain-version run")
    return counts, sample_s


def time_train_kernels(gen, card, errs, counts):
    """Phase 5, training kernels: the attention backward at each call site
    (the JSON row at the trunk's global crops) against its plain version and
    SDPA forward+backward on split, pre-roped q/k/v; the fused CE at each of
    the step's row sets (the JSON rows at iBOT's), no one-call yardstick."""
    import torch
    import torch.nn.functional as F

    from vtp_tpu_torch.ops import fused_ce
    from vtp_tpu_torch.ops.flash_attention import (
        BWD_NAME,
        fused_qkv_rope_attention_bwd,
        fused_qkv_rope_attention_bwd_reference,
    )
    from vtp_tpu_torch.ops.rope import rope_apply

    bw, bf16_peak, fp32_peak = next((v for k, v in PEAKS.items() if k in card), PEAKS["H100"])
    rows = []
    for name, B, N, H, grid, prefix, causal in TRAIN_ATTENTION:
        qkv, (sin, cos), _ = _attention_inputs(gen, B, N, H, torch.bfloat16, grid, prefix)
        g = torch.randn((B, N, H * 64), generator=gen, device="cuda").bfloat16()
        kern = lambda: fused_qkv_rope_attention_bwd(qkv, g, sin, cos, H, 0, causal)
        plain = lambda: fused_qkv_rope_attention_bwd_reference(qkv, g, sin, cos, H, 0, causal)
        q, k, v = qkv.reshape(B, N, 3, H, 64).unbind(2)
        if sin is not None:
            s, c = sin[None, :, None, :], cos[None, :, None, :]
            q, k = rope_apply(q, s, c), rope_apply(k, s, c)
        q, k, v = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        gt = g.reshape(B, N, H, 64).transpose(1, 2).contiguous()

        def lib():
            out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
            torch.autograd.grad(out, (q, k, v), gt)

        tm = _timings(kern, plain, lib)
        nbytes = B * N * 7 * H * 64 * 2
        pairs = N * (N + 1) / 2 if causal else N * N
        flops = 10 * B * H * pairs * 64
        t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
        print(f"timing attention_bwd {name} B={B} N={N} H={H} on {card}: "
              f"{_fmt_times(tm, 'sdpa fwd+bwd')}, bound "
              f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
              flush=True)
        if name == "trunk_globals":
            rows.append({
                "name": BWD_NAME, "route": "cuda", "source": BWD_SOURCE, "replaces": BWD_REPLACES,
                "launches": counts.get(BWD_NAME, 0), "max_abs_err": errs["attention_bwd"],
                **tm, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            })
    for name, R, C in TRAIN_CE:
        t = torch.randn((R, C), generator=gen, device="cuda").bfloat16()
        s = torch.randn((R, C), generator=gen, device="cuda").bfloat16()
        center = 0.1 * torch.randn(C, generator=gen, device="cuda")
        g = torch.rand(R, generator=gen, device="cuda")
        _, stats = fused_ce.fused_ce_fwd(t, s, center, 0.07, 0.1)
        timed = {
            "fwd": (lambda: fused_ce.fused_ce_fwd(t, s, center, 0.07, 0.1),
                    lambda: fused_ce.fused_ce_fwd_reference(t, s, center, 0.07, 0.1),
                    2 * R * C * 2 + C * 4 + 5 * R * 4),
            "bwd": (lambda: fused_ce.fused_ce_bwd(t, s, center, g, stats, 0.07, 0.1),
                    lambda: fused_ce.fused_ce_bwd_reference(t, s, center, g, stats, 0.07, 0.1),
                    3 * R * C * 2 + C * 4 + 5 * R * 4),
        }
        for part, (kern, plain, nbytes) in timed.items():
            tm = _timings(kern, plain)
            # about a dozen fp32 operations an element (two exps), outside the tensor cores
            t_bytes, t_ops = nbytes / bw * 1e3, 12 * R * C / fp32_peak * 1e3
            print(f"timing fused_ce_{part} {name} R={R} C={C} on {card}: {_fmt_times(tm)}, "
                  f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB)", flush=True)
            if name == "ibot":
                kname = fused_ce.FWD_NAME if part == "fwd" else fused_ce.BWD_NAME
                rows.append({
                    "name": kname, "route": "cuda", "source": CE_SOURCE,
                    "replaces": CE_REPLACES[part], "launches": counts.get(kname, 0),
                    "max_abs_err": errs[f"fused_ce_{part}"], **tm,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                })
    return rows


def time_dit_kernels(gen, card, errs, counts):
    """Phase 7, DiT kernels at DiT-XL/1's attention shape: the forward's
    qk-norm arm (a JSON row of its own; also printed at the sampler's batch)
    and the backward's qk-norm arm (a JSON row) against their plain versions
    and SDPA on split, pre-normed, pre-roped q/k/v (forward, and
    forward+backward for the backward). SDPA leaves out the norm and its
    adjoint."""
    import torch
    import torch.nn.functional as F

    from vtp_tpu_torch.ops.flash_attention import (
        NORM_BWD_NAME,
        NORM_NAME,
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_qk_norm_bwd,
        fused_qkv_rope_attention_qk_norm_bwd_reference,
        fused_qkv_rope_attention_reference,
    )
    from vtp_tpu_torch.ops.norms import rms_norm
    from vtp_tpu_torch.ops.rope import rope_apply

    bw, bf16_peak, _ = next((v for k, v in PEAKS.items() if k in card), PEAKS["H100"])
    B, N, H, grid = DIT_ATTENTION
    qkv, (sin, cos), (qs, ks) = _attention_inputs(gen, B, N, H, torch.bfloat16, grid, 0, True)
    g = torch.randn((B, N, H * 64), generator=gen, device="cuda").bfloat16()
    q, k, v = qkv.reshape(B, N, 3, H, 64).unbind(2)
    s, c = sin[None, :, None, :], cos[None, :, None, :]
    q = rope_apply(rms_norm(q, qs).bfloat16(), s, c)
    k = rope_apply(rms_norm(k, ks).bfloat16(), s, c)
    q, k, v = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    gt = g.reshape(B, N, H, 64).transpose(1, 2).contiguous()

    def lib_bwd():
        out = F.scaled_dot_product_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), gt)

    D = H * 64
    rows = []
    for batch in (B, SAMPLE_BATCH):
        # the train step's batch (the JSON row), then the sampler's
        xq = qkv[:batch]
        with torch.no_grad():
            tm = _timings(lambda: fused_qkv_rope_attention(xq, sin, cos, H, qs, ks),
                         lambda: fused_qkv_rope_attention_reference(xq, sin, cos, H, qs, ks),
                         lambda: F.scaled_dot_product_attention(q[:batch], k[:batch], v[:batch]))
        fwd_bytes, fwd_flops = batch * N * 4 * D * 2, 4 * batch * H * N * N * 64
        t_bytes, t_ops = fwd_bytes / bw * 1e3, fwd_flops / bf16_peak * 1e3
        print(f"timing {NORM_NAME} DiT-XL/1 B={batch} N={N} H={H} on {card}: "
              f"{_fmt_times(tm)} (no norm), bound "
              f"{max(t_bytes, t_ops):.4f} ms ({fwd_bytes / 1e6:.1f} MB, {fwd_flops / 1e9:.2f} "
              f"GFLOP)", flush=True)
        if batch == B:
            rows.append({
                "name": NORM_NAME, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                "launches": counts.get(NORM_NAME, 0), "max_abs_err": errs["bf16_qk_norm"],
                **tm, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            })
    tm = _timings(
        lambda: fused_qkv_rope_attention_qk_norm_bwd(qkv, g, sin, cos, qs, ks, H),
        lambda: fused_qkv_rope_attention_qk_norm_bwd_reference(qkv, g, sin, cos, qs, ks, H),
        lib_bwd)
    # qkv and g read once, d(qkv) written once (the scales and the dw rows are
    # under 0.2% of it); scores recomputed, dv, dp, dq, dk
    nbytes = 7 * B * N * D * 2
    flops = 10 * B * H * N * N * 64
    t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
    print(f"timing attention_bwd_qk_norm DiT-XL/1 B={B} N={N} H={H} on {card}: "
          f"{_fmt_times(tm, 'sdpa fwd+bwd')} (no norm), bound "
          f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
          flush=True)
    return rows + [{
        "name": NORM_BWD_NAME, "route": "cuda", "source": BWD_SOURCE, "replaces": BWD_REPLACES,
        "launches": counts.get(NORM_BWD_NAME, 0), "max_abs_err": errs["attention_bwd_qk_norm"],
        **tm, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }]


def time_kernels(gen, card, errs, counts):
    """Phase 5: each forward arm at the roundtrip's shapes."""
    import torch
    import torch.nn.functional as F

    from vtp_tpu_torch.ops.flash_attention import (
        arm_name,
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_reference,
    )
    from vtp_tpu_torch.ops.rope import rope_apply

    bw, bf16_peak, fp32_peak = next((v for k, v in PEAKS.items() if k in card), PEAKS["H100"])
    H, d = 16, 64
    rows = []
    # arm, dtype, N, prefix, fp32 precision, passes, peak rate of the passes: the bf16x3
    # arm's three passes are bf16 products, bounded at the bf16 tensor-core rate it
    # was defined for; its SDPA yardstick is the exact fp32 arm's (no single call
    # computes the split)
    arms = (("bf16", torch.bfloat16, 257, 1, "float32", 1, bf16_peak),
            ("fp32", torch.float32, 256, 0, "float32", 1, fp32_peak),
            ("fp32_bf16x3", torch.float32, 256, 0, "high", 3, bf16_peak))
    for key, dt, N, prefix, prec, passes, peak in arms:
        qkv, (sin, cos), _ = _attention_inputs(gen, BATCH, N, H, dt, 16, prefix)
        kern = lambda: fused_qkv_rope_attention(qkv, sin, cos, H, fp32_precision=prec)
        plain = lambda: fused_qkv_rope_attention_reference(qkv, sin, cos, H, fp32_precision=prec)
        # SDPA yardstick on pre-split, pre-roped (B, H, N, d) operands
        q, k, v = qkv.reshape(BATCH, N, 3, H, d).unbind(2)
        s, c = sin[None, :, None, :], cos[None, :, None, :]
        q = rope_apply(q.to(torch.bfloat16), s, c).to(dt).transpose(1, 2).contiguous()
        k = rope_apply(k.to(torch.bfloat16), s, c).to(dt).transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()
        lib = lambda: F.scaled_dot_product_attention(q, k, v)
        tm = _timings(kern, plain, lib)
        item = torch.finfo(dt).bits // 8
        nbytes = BATCH * N * (3 * H * d + H * d) * item
        flops = passes * 4 * BATCH * H * N * N * d
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        arm = arm_name(dt, prec)
        rows.append({
            "name": arm, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": counts.get(arm, 0), "max_abs_err": errs[key],
            **tm, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
        print(f"timing {arm} B={BATCH} N={N} H={H} on {card}: {_fmt_times(tm)}"
              f"{' (exact fp32; no single call computes the split)' if passes > 1 else ''}, "
              f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
              flush=True)
    return rows


def time_flash_kernels(gen, card, errs, counts):
    """Phase 5, the strided attention: each entry at its main path's shape
    (the text entry on the text path's strided view), its plain version and
    SDPA on the same bf16 (B, H, N, d) operands, and its bound."""
    import torch
    import torch.nn.functional as F

    from vtp_tpu_torch.ops import flash_attention as fa

    bw, bf16_peak, _ = next((v for k, v in PEAKS.items() if k in card), PEAKS["H100"])
    rows = []
    for bnhd, (B, N, H, d) in ((True, FLASH_TRUNK), (False, FLASH_TEXT)):
        q, k, v = _flash_inputs(gen, bnhd, B, N, H, d, view=not bnhd)
        if bnhd:
            name, kern, plain = (fa.FLASH_BNHD_NAME, fa.flash_attention_bnhd,
                                 fa.flash_attention_bnhd_reference)
            lq, lk, lv = (t.transpose(1, 2) for t in (q, k, v))
        else:
            name, kern, plain = fa.FLASH_NAME, fa.flash_attention, fa.flash_attention_reference
            lq, lk, lv = q, k, v
        with torch.no_grad():
            tm = _timings(lambda: kern(q, k, v), lambda: plain(q, k, v),
                         lambda: F.scaled_dot_product_attention(lq, lk, lv))
        nbytes = 4 * B * N * H * d * 2
        flops = 4 * B * H * N * N * d
        t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES["bnhd" if bnhd else "bhnd"],
            "launches": counts.get(name, 0), "max_abs_err": errs[name],
            **tm, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
        print(f"timing {name} B={B} N={N} H={H} d={d} on {card}: {_fmt_times(tm)}, "
              f"bound {max(t_bytes, t_ops):.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    return rows


def _hold_metrics(label, metrics, plain, limits):
    """Each metric of ``metrics`` against ``plain``'s within its limit
    (relative unless the name ends in "_abs"); raises on a miss."""
    for name, limit in limits.items():
        key = name.removesuffix("_abs")
        got, ref = float(metrics[key]), float(plain[key])
        diff = abs(got - ref) if name.endswith("_abs") else abs(got - ref) / abs(ref)
        ok = diff <= limit and math.isfinite(got)
        print(f"{label} {key:11s} kernels {got:.6f} plain {ref:.6f} "
              f"{'abs' if name.endswith('_abs') else 'rel'} diff {diff:.3e} (limit {limit:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label} {key} disagrees with the plain-version run")


def head_dim_vtp_config(d):
    """VTP-L at its widths with heads of d, HEAD_DIM_DEPTH deep."""
    import dataclasses

    from vtp_tpu_torch import vtp_large

    heads = HEAD_DIM_HEADS[d]
    return dataclasses.replace(
        vtp_large(), vision_num_heads=heads["vision"], decoder_num_heads=heads["decoder"],
        text_num_heads=heads["text"], vision_depth=HEAD_DIM_DEPTH,
        decoder_depth=HEAD_DIM_DEPTH, text_depth=HEAD_DIM_DEPTH)


def run_head_dim_vtp(gen, d):
    """Head dim d on the VTP-L path: the roundtrip at B = BATCH with the
    exact and the "high" decode and one CLIP+SSL+rec train step (remat
    off), each counted (every launch at d, none at 64) and held against the
    same run on the plain versions by the gates of the full-depth runs.
    Returns the launches of those runs."""
    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, HIGH_NAME, at_head_dim
    from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state

    cfg = head_dim_vtp_config(d)
    model = VTPModel.init(cfg, gen, device="cuda")
    images = torch.randn((BATCH, 3, cfg.image_size, cfg.image_size), generator=gen, device="cuda")
    total = {}

    def tally(run, want):
        counts = launch_counts()
        print(f"head dim {d}: {run}: kernel launches {counts} (expected {want})", flush=True)
        if counts != want:
            raise AssertionError(f"head dim {d} {run} launches {counts}, expected {want}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    latents = model.get_reconstruction_latents(images)
    recon = model.get_latents_decoded_images(latents)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    tally("roundtrip", {at_head_dim(ARM_NAME[torch.bfloat16], d): cfg.vision_depth,
                        at_head_dim(ARM_NAME[torch.float32], d): cfg.decoder_depth})
    reset_launch_counts()
    high = model.get_latents_decoded_images(latents, precision="high")
    torch.cuda.synchronize()
    tally("high decode", {at_head_dim(HIGH_NAME, d): cfg.decoder_depth})
    with plain_kernels():
        ref_latents = model.get_reconstruction_latents(images)
        ref_recon = model.get_latents_decoded_images(latents)
        ref_high = model.get_latents_decoded_images(latents, precision="high")
    torch.cuda.synchronize()
    lat_err = ((latents.float() - ref_latents.float()).abs().max()
               / ref_latents.float().abs().max()).item()
    img_err = (recon - ref_recon).abs().max().item()
    high_err = (high - ref_high).abs().max().item()
    high_exact = ((high - recon).abs().max() / recon.abs().max()).item()
    ok = (lat_err <= 5e-2 and img_err <= 1e-3 and high_err <= 1e-3 and high_exact <= 1e-3
          and all(torch.isfinite(t).all().item() for t in (latents, recon, high)))
    print(f"head dim {d}: roundtrip VTP-L widths, {cfg.vision_num_heads} heads of {d}, depth "
          f"{HEAD_DIM_DEPTH}, B={BATCH} ({run_s * 1e3:.1f} ms, first call) vs plain versions: "
          f"latents max err {lat_err:.3e} of max|ref| (limit 5e-2), images max abs err "
          f"{img_err:.3e} (limit 1e-3); high decode vs plain {high_err:.3e} abs (limit 1e-3), vs "
          f"the exact decode {high_exact:.3e} of max|ref| (limit 1e-3) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"head dim {d} roundtrip disagrees with the plain-version run")
    del model, latents, recon, high, ref_latents, ref_recon, ref_high

    tcfg = TrainConfig(warmup_steps=0, total_steps=1000, remat=False)
    state = init_state(cfg, tcfg, gen, device="cuda")
    batch = _train_batch(gen, cfg)
    step = build_train_step(cfg, tcfg)
    plain_state = copy.deepcopy(state)
    torch.cuda.synchronize()
    reset_launch_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    tally("train step", expected_train_launches(cfg, d))
    with plain_kernels():
        _, plain = step(plain_state, batch)
    torch.cuda.synchronize()
    _hold_metrics(f"head dim {d}: train", metrics,
                  plain, {name: 2e-2 if name == "grad_norm" else 5e-3 for name in metrics})
    del state, plain_state, batch, step
    torch.cuda.empty_cache()
    return total


def run_head_dim_dit(gen, d, latents):
    """Head dim d on the DiT path: DiT-XL/1 at 1152 wide in
    HEAD_DIM_HEADS[d]["dit"] heads (a free choice of ``make_dit_config``),
    HEAD_DIM_DEPTH deep, adaLN-zero leaves re-drawn; one train step at
    B = DIT_BATCH (qk-norm forward and backward, remat on) and a
    HEAD_DIM_SAMPLE_STEPS-step sample of SAMPLE_BATCH latents, each counted
    and held against the same run on the plain versions (losses 5e-3 rel,
    grad norm 2e-2 rel, latents 5e-2 of max|ref|). Returns the launches."""
    import torch

    from vtp_tpu_torch.dit.model import make_dit_config
    from vtp_tpu_torch.dit.sample import make_sampler
    from vtp_tpu_torch.dit.train import DiTTrainConfig, build_dit_train_step, init_dit_state
    from vtp_tpu_torch.models.initializers import normal_
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import NORM_BWD_NAME, NORM_NAME, at_head_dim

    cfg = make_dit_config("DiT-XL/1", num_heads=HEAD_DIM_HEADS[d]["dit"], depth=HEAD_DIM_DEPTH)
    tcfg = DiTTrainConfig(total_steps=1000)
    state = init_dit_state(cfg, tcfg, gen, device="cuda")
    model = state.model
    with torch.no_grad():
        for lin in [b.ada for b in model.blocks] + [model.final.ada, model.final.proj]:
            normal_(lin.weight, 0.02, gen)
            normal_(lin.bias, 0.02, gen)
        state.ema.load_state_dict(model.state_dict())
    labels = torch.randint(0, cfg.num_classes, (DIT_BATCH,), generator=gen, device="cuda")
    draws = {"drop": torch.rand(DIT_BATCH, generator=gen, device="cuda") < tcfg.class_dropout_prob,
             "t": torch.sigmoid(tcfg.lognorm_mu + tcfg.lognorm_sigma
                                * torch.randn(DIT_BATCH, generator=gen, device="cuda")),
             "x0": torch.randn(latents.shape, generator=gen, device="cuda")}
    step = build_dit_train_step(cfg, tcfg)
    plain_state = copy.deepcopy(state)
    total = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    state, metrics = step(state, latents, labels, gen, draws)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {at_head_dim(NORM_NAME, d): 2 * cfg.depth, at_head_dim(NORM_BWD_NAME, d): cfg.depth}
    print(f"head dim {d}: dit train step ({cfg.num_heads} heads of {d}, depth {cfg.depth}, "
          f"B={DIT_BATCH}): kernel launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"head dim {d} DiT train step launches {counts}, expected {want}")
    total.update(counts)
    with plain_kernels():
        _, plain = step(plain_state, latents, labels, gen, draws)
    torch.cuda.synchronize()
    _hold_metrics(f"head dim {d}: dit train", metrics,
                  plain, {name: 2e-2 if name == "grad_norm" else 5e-3 for name in metrics})
    del plain_state

    sample_labels = torch.arange(SAMPLE_BATCH, device="cuda") * (cfg.num_classes // SAMPLE_BATCH)
    noise = torch.randn((SAMPLE_BATCH, cfg.in_channels, cfg.input_size, cfg.input_size),
                        generator=gen, device="cuda")
    short = make_sampler(cfg, num_steps=HEAD_DIM_SAMPLE_STEPS)
    reset_launch_counts()
    z = short(state.ema, sample_labels, noise=noise)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {at_head_dim(NORM_NAME, d): HEAD_DIM_SAMPLE_STEPS * cfg.depth}
    if counts != want:
        raise AssertionError(f"head dim {d} sample launches {counts}, expected {want}")
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n
    with plain_kernels():
        z_ref = short(state.ema, sample_labels, noise=noise)
    torch.cuda.synchronize()
    err = ((z - z_ref).abs().max() / z_ref.abs().max()).item()
    ok = err <= 5e-2 and torch.isfinite(z).all().item()
    print(f"head dim {d}: {HEAD_DIM_SAMPLE_STEPS}-step sample, kernel launches {counts}; latents "
          f"vs plain versions max err {err:.3e} of max|ref| (limit 5e-2) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"head dim {d} sampler latents disagree with the plain-version run")
    del state, step
    torch.cuda.empty_cache()
    return total


def check_head_dim_edges():
    """Every forward arm and both backward arms at head dims 32 and 128 on
    the edge cases (check_edges_fwd, check_edges_fp32, check_edges_bwd),
    each on its own seeded generator."""
    import torch

    dims = (32, 128)
    check_edges_fwd(dims)
    check_edges_fp32("float32", tuple(sorted(EDGE_N + EXACT_EDGE_N)), dims)
    check_edges_fp32("high", EDGE_N, dims)
    check_edges_bwd(torch.Generator(device="cuda").manual_seed(SEED + 32), False, dims)
    check_edges_bwd(torch.Generator(device="cuda").manual_seed(SEED + 128), True, dims)


def time_head_dim_kernels(gen, card, counts):
    """Every forward arm at (BATCH, 257 bf16 / 256 fp32, 1024 wide) and both
    backward arms at (2 BATCH, 257, 1024 wide), at head dims 32 and 128,
    with RoPE on a 16 x 16 grid: held against their plain versions at the
    arms' gates (bf16 1e-2 of max|ref|, fp32 1e-4 abs, dw 1e-2 rel), then
    timed beside the plain version, SDPA on the same pre-normed, pre-roped
    operands (fwd+bwd for the backward) and the bound. One JSON row each."""
    import torch
    import torch.nn.functional as F

    from vtp_tpu_torch.ops import flash_attention as fa
    from vtp_tpu_torch.ops.norms import rms_norm
    from vtp_tpu_torch.ops.rope import rope_apply

    bw, bf16_peak, fp32_peak = next((v for k, v in PEAKS.items() if k in card), PEAKS["H100"])
    bf16, fp32 = torch.bfloat16, torch.float32
    rows = []
    for d in (32, 128):
        H = 1024 // d
        # arm, dtype, N, prefix, fp32 precision, qk-norm, passes, peak of the passes
        fwd = (("bf16", bf16, 257, 1, "float32", False, 1, bf16_peak),
               ("bf16_qk_norm", bf16, 257, 1, "float32", True, 1, bf16_peak),
               ("fp32", fp32, 256, 0, "float32", False, 1, fp32_peak),
               ("fp32_bf16x3", fp32, 256, 0, "high", False, 3, bf16_peak))
        for key, dt, N, prefix, prec, qk_norm, passes, peak in fwd:
            qkv, (sin, cos), (qs, ks) = _attention_inputs(gen, BATCH, N, H, dt, 16, prefix,
                                                          qk_norm, d=d)
            kern = lambda: fa.fused_qkv_rope_attention(qkv, sin, cos, H, qs, ks,
                                                       fp32_precision=prec)
            plain = lambda: fa.fused_qkv_rope_attention_reference(qkv, sin, cos, H, qs, ks,
                                                                  fp32_precision=prec)
            with torch.no_grad():
                got, want = kern(), plain()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            ok = (err <= 1e-2 * scale if dt is bf16 else err <= 1e-4) and torch.isfinite(got).all().item()
            name = fa.arm_name(dt, prec, qk_norm, d)
            print(f"kernel {name} B={BATCH} N={N} H={H} d={d}: max abs err {err:.3e} (max|ref| "
                  f"{scale:.3e}; limit {'1e-2 rel' if dt is bf16 else '1e-4 abs'}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")
            q, k, v = qkv.reshape(BATCH, N, 3, H, d).unbind(2)
            if qk_norm:
                q, k = rms_norm(q, qs).to(dt), rms_norm(k, ks).to(dt)
            s, c = sin[None, :, None, :], cos[None, :, None, :]
            q = rope_apply(q.to(bf16), s, c).to(dt).transpose(1, 2).contiguous()
            k = rope_apply(k.to(bf16), s, c).to(dt).transpose(1, 2).contiguous()
            v = v.transpose(1, 2).contiguous()
            with torch.no_grad():
                tm = _timings(kern, plain, lambda: F.scaled_dot_product_attention(q, k, v))
            item = torch.finfo(dt).bits // 8
            nbytes = BATCH * N * 4 * H * d * item
            flops = passes * 4 * BATCH * H * N * N * d
            t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
            rows.append({"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                         "launches": counts.get(name, 0), "max_abs_err": err, **tm,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            print(f"timing {name} B={BATCH} N={N} H={H} d={d} on {card}: {_fmt_times(tm)}"
                  f"{' (no norm)' if qk_norm else ''}, bound {max(t_bytes, t_ops):.4f} ms "
                  f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
        B, N = 2 * BATCH, 257
        for qk_norm in (False, True):
            qkv, (sin, cos), (qs, ks) = _attention_inputs(gen, B, N, H, bf16, 16, 1, qk_norm, d=d)
            g = torch.randn((B, N, H * d), generator=gen, device="cuda").bfloat16()
            if qk_norm:
                kern = lambda: fa.fused_qkv_rope_attention_qk_norm_bwd(qkv, g, sin, cos, qs, ks, H)
                plain = lambda: fa.fused_qkv_rope_attention_qk_norm_bwd_reference(
                    qkv, g, sin, cos, qs, ks, H)
            else:
                kern = lambda: (fa.fused_qkv_rope_attention_bwd(qkv, g, sin, cos, H),)
                plain = lambda: (fa.fused_qkv_rope_attention_bwd_reference(qkv, g, sin, cos, H),)
            got, want = kern(), plain()
            err = (got[0].float() - want[0].float()).abs().max().item()
            scale = want[0].float().abs().max().item()
            dw_err = max([0.0] + [(a - b).abs().max().item() / b.abs().max().item()
                                  for a, b in zip(got[1:], want[1:])])
            ok = (err <= 1e-2 * scale and dw_err <= 1e-2
                  and all(torch.isfinite(t).all().item() for t in got))
            name = fa.at_head_dim(fa.NORM_BWD_NAME if qk_norm else fa.BWD_NAME, d)
            print(f"kernel {name} B={B} N={N} H={H} d={d}: d(qkv) max abs err {err:.3e} (max|ref| "
                  f"{scale:.3e}; limit 1e-2 rel), dw max rel err {dw_err:.3e} (limit 1e-2) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")
            q, k, v = qkv.reshape(B, N, 3, H, d).unbind(2)
            if qk_norm:
                q, k = rms_norm(q, qs).bfloat16(), rms_norm(k, ks).bfloat16()
            s, c = sin[None, :, None, :], cos[None, :, None, :]
            q, k = rope_apply(q, s, c), rope_apply(k, s, c)
            q, k, v = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            gt = g.reshape(B, N, H, d).transpose(1, 2).contiguous()

            def lib():
                out = F.scaled_dot_product_attention(q, k, v)
                torch.autograd.grad(out, (q, k, v), gt)

            tm = _timings(kern, plain, lib)
            nbytes = 7 * B * N * H * d * 2
            flops = 10 * B * H * N * N * d
            t_bytes, t_ops = nbytes / bw * 1e3, flops / bf16_peak * 1e3
            rows.append({"name": name, "route": "cuda", "source": BWD_SOURCE,
                         "replaces": BWD_REPLACES, "launches": counts.get(name, 0),
                         "max_abs_err": err, **tm, "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            print(f"timing {name} B={B} N={N} H={H} d={d} on {card}: "
                  f"{_fmt_times(tm, 'sdpa fwd+bwd')}{' (no norm)' if qk_norm else ''}, bound "
                  f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
                  flush=True)
    return rows


def _eval_batches(gen, n, batch, size):
    """n seeded images (uniform pixels, ImageNet-normalised) in batches, as
    (images, labels) pairs on the card: an in-memory loader."""
    import torch

    from vtp_tpu_torch.utils.image import normalize_nchw

    out = []
    for _ in range(n // batch):
        x = torch.rand((batch, 3, size, size), generator=gen, device="cuda")
        labels = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
        out.append((normalize_nchw(x), labels))
    return out


def run_recon_eval(gen, model):
    """The reconstruction eval: ``evaluate_reconstruction`` on the VTP-L
    model over EVAL_IMAGES seeded 256^2 images in batches of EVAL_BATCH (an
    in-memory loader; no PIL, no save_dir), LPIPS and Inception from seeded
    torch-layout state dicts through the port's converters; counted (every
    batch's encode and exact decode) and held against the same eval on the
    plain versions. Tolerances from the roundtrip's latents gate (5e-2 of
    max|ref|), which the plain run's re-encode differs by: each metric a
    smooth function of the images, held within 5e-2 relative, PSNR within
    0.5 dB (20 log10 of the error changes by 8.7 dB x a relative change of
    5e-2) and SSIM within 5e-2 abs. Returns the launches."""
    import torch

    from vtp_tpu_torch.eval.reconstruction import evaluate_reconstruction
    from vtp_tpu_torch.metrics import inception, lpips
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME

    cfg = model.config
    loader = _eval_batches(gen, EVAL_IMAGES, EVAL_BATCH, cfg.image_size)
    metric = lpips.LPIPS(state_dict=lpips.random_state_dict(SEED), device="cuda")
    params = inception.convert_inception_state_dict(inception.random_state_dict(SEED), device="cuda")
    feature_fn = lambda x: inception.inception_features(params, x)
    run = lambda: evaluate_reconstruction(model, loader, lpips_metric=metric,
                                          inception_feature_fn=feature_fn)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = launch_counts()
    n_batches = EVAL_IMAGES // EVAL_BATCH
    want = {ARM_NAME[torch.bfloat16]: cfg.vision_depth * n_batches,
            ARM_NAME[torch.float32]: cfg.decoder_depth * n_batches}
    print(f"reconstruction eval VTP-L, {res['num_samples']} images 256^2 in batches of "
          f"{EVAL_BATCH}: psnr {res['psnr']:.4f} dB, ssim {res['ssim']:.6f}, lpips "
          f"{res['lpips']:.6f}, rfid {res['rfid']:.4f}, {eval_s:.2f} s (host clock, one run, "
          f"seeded random weights and images); kernel launches {counts} (expected {want})",
          flush=True)
    if counts != want or res["num_samples"] != EVAL_IMAGES:
        raise AssertionError(f"reconstruction eval launches {counts}, expected {want}")
    with plain_kernels():
        plain = run()
    _hold_metrics("reconstruction eval", res, plain,
                  {"psnr_abs": 0.5, "ssim_abs": 5e-2, "lpips": 5e-2, "rfid": 5e-2})
    return counts


def run_zero_shot(gen, model):
    """The zero-shot eval: a synthetic merges file (``write_merges_file`` over
    the prompts) in a temporary directory and a ``SimpleTokenizer`` on it;
    ``build_zero_shot_classifier`` over every classname with ZS_TEMPLATES
    templates on the VTP-L text tower (causal fused launches counted); then
    ZS_IMAGES seeded images scored (logits 100 x feature @ classifier, top-1
    and top-5 counts by ``evaluate_zero_shot``). The classifier and the
    logits are held against the same on the plain versions within 5e-2 of
    max|ref| (the bf16 features' gate). Returns the launches."""
    import os
    import tempfile

    import torch

    from vtp_tpu_torch.eval.zero_shot import (
        build_zero_shot_classifier,
        evaluate_zero_shot,
        load_imagenet_classnames,
        load_openai_templates,
    )
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME
    from vtp_tpu_torch.tokenizers.bpe import SimpleTokenizer, write_merges_file

    cfg = model.config
    classnames, templates = load_imagenet_classnames(), load_openai_templates()[:ZS_TEMPLATES]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "merges.txt.gz")
        n_merges = write_merges_file(path, [t.format(c) for c in classnames for t in templates])
        tokenizer = SimpleTokenizer(path, context_length=cfg.text_context_length)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    classifier = build_zero_shot_classifier(model, tokenizer, classnames, templates)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = launch_counts()
    chunks = -(-len(classnames) // 10)
    want = {ARM_NAME[torch.bfloat16]: cfg.text_depth * chunks}
    print(f"zero-shot: {n_merges} synthetic merges, vocab {tokenizer.vocab_size}; classifier "
          f"{tuple(classifier.shape)} over {len(classnames)} classes x {len(templates)} templates "
          f"in {build_s:.2f} s (host clock); kernel launches {counts} (expected {want})",
          flush=True)
    if counts != want or tuple(classifier.shape) != (cfg.text_embed_dim, len(classnames)):
        raise AssertionError(f"zero-shot classifier launches {counts}, expected {want}")
    batches = _eval_batches(gen, ZS_IMAGES, ZS_BATCH, cfg.image_size)
    reset_launch_counts()
    top1, top5 = evaluate_zero_shot(model, classifier, batches)
    torch.cuda.synchronize()
    eval_counts = launch_counts()
    want = {ARM_NAME[torch.bfloat16]: cfg.vision_depth * len(batches)}
    if eval_counts != want:
        raise AssertionError(f"zero-shot eval launches {eval_counts}, expected {want}")
    for name, n in eval_counts.items():
        counts[name] = counts.get(name, 0) + n
    images = torch.cat([x for x, _ in batches])
    logits = 100.0 * model.get_clip_image_feature(images).float() @ classifier
    with plain_kernels():
        plain_classifier = build_zero_shot_classifier(model, tokenizer, classnames, templates)
        plain_logits = 100.0 * model.get_clip_image_feature(images).float() @ plain_classifier
    torch.cuda.synchronize()
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in ((classifier, plain_classifier), (logits, plain_logits))]
    ok = max(errs) <= 5e-2 and torch.isfinite(logits).all().item()
    print(f"zero-shot: {ZS_IMAGES} images, top-1 {top1:.2f}% top-5 {top5:.2f}% (random weights); "
          f"classifier vs plain versions max err {errs[0]:.3e} of max|ref|, logits {errs[1]:.3e} "
          f"(limit 5e-2) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the zero-shot classifier or logits disagree with the plain run")
    return counts


def _rel_err(a, b) -> float:
    """max|a - b| / max|b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _probe_logits(model, state, batches, pcfg):
    """{group: (L, images, classes)} logits of the probe's heads."""
    import torch

    from vtp_tpu_torch.eval.linear_probe import create_linear_input, extract_features, head_logits
    from vtp_tpu_torch.models.pixel_decoder import exact_fp32

    out = {}
    with torch.no_grad(), exact_fp32():
        for images, _ in batches:
            feats = extract_features(model, images, pcfg.feature_blocks)
            for n in pcfg.n_last_blocks_list:
                h = state["heads"][f"n{n}"]
                out.setdefault(f"n{n}", []).append(
                    head_logits(h["w"], h["b"], create_linear_input(feats, n)))
    return {k: torch.cat(v, dim=1) for k, v in out.items()}


def run_linear_probe(gen, model):
    """The linear probe: the VTP-L model's frozen trunk at full depth and
    width, ``ProbeConfig(n_last_blocks_list=(1, 4))`` with the 13 rates over
    1000 classes, heads from ``init_probe_heads``; PROBE_STEPS train steps at
    B = PROBE_BATCH on seeded PROBE_SIZE^2 images, then
    ``evaluate_linear_probe`` over PROBE_EVAL_BATCHES batches; counted (24
    bf16 fused launches a forward) and timed, then run again from the same
    state on the plain versions. Held: each step's loss within 5e-3 rel; the
    heads' change over the steps and the final heads' logits on the eval
    images within 5e-2 of max|ref| (the bf16 features' gate); each head's
    hit count off the plain run's by no more than the images whose plain
    top-2 logits lie within that logits gate of each other. Returns the
    launches."""
    import torch

    from vtp_tpu_torch.eval.linear_probe import (
        ProbeConfig,
        build_probe_train_step,
        evaluate_linear_probe,
        head_names,
        init_probe_heads,
        init_probe_state,
    )
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME

    cfg = model.config
    pcfg = ProbeConfig(n_last_blocks_list=(1, 4), num_classes=1000, epochs=1,
                       epoch_length=PROBE_STEPS, batch_size=PROBE_BATCH)
    state0 = init_probe_state(init_probe_heads(cfg, pcfg, PROBE_BATCH, gen, device="cuda"))
    train = _eval_batches(gen, PROBE_STEPS * PROBE_BATCH, PROBE_BATCH, PROBE_SIZE)
    val = _eval_batches(gen, PROBE_EVAL_BATCHES * PROBE_BATCH, PROBE_BATCH, PROBE_SIZE)
    step = build_probe_train_step(model, pcfg)

    def run():
        state, losses = state0, []
        for images, labels in train:
            state, loss = step(state, images, labels)
            losses.append(loss)
        return state, torch.stack(losses), evaluate_linear_probe(model, state, val, pcfg)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, losses, accs = run()
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {ARM_NAME[torch.bfloat16]: cfg.vision_depth * (PROBE_STEPS + PROBE_EVAL_BATCHES)}
    best = max(accs, key=accs.get)
    print(f"linear probe VTP-L {PROBE_SIZE}^2, {PROBE_STEPS} steps at B={PROBE_BATCH} + "
          f"{PROBE_EVAL_BATCHES} eval batches, 26 heads (n 1 and 4 x 13 rates, 1000 classes): "
          f"losses {', '.join(f'{x:.4f}' for x in losses.tolist())}, best {accs[best]:.2f}% "
          f"({best}; random weights and labels), {probe_s:.2f} s (host clock, one run); kernel "
          f"launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"linear probe launches {counts}, expected {want}")
    logits = _probe_logits(model, state, val, pcfg)
    with plain_kernels():
        p_state, p_losses, p_accs = run()
        p_logits = _probe_logits(model, p_state, val, pcfg)
    torch.cuda.synchronize()
    loss_err = ((losses - p_losses).abs() / p_losses.abs()).max().item()
    head_err = max(_rel_err(state["heads"][k][leaf] - state0["heads"][k][leaf],
                            p_state["heads"][k][leaf] - state0["heads"][k][leaf])
                   for k in state0["heads"] for leaf in ("w", "b"))
    logit_err = max(_rel_err(logits[k], p_logits[k]) for k in logits)
    n_val = PROBE_EVAL_BATCHES * PROBE_BATCH
    worst = 0
    for key, (group, idx) in head_names(pcfg, pcfg.batch_size).items():
        ref = p_logits[group][idx]
        top2 = ref.topk(2, dim=-1).values
        ties = int((top2[:, 0] - top2[:, 1] <= FEATURE_REL * ref.abs().max()).sum().item())
        off = round(abs(accs[key] - p_accs[key]) * n_val / 100.0)
        worst = max(worst, off)
        if off > ties:
            raise AssertionError(f"linear probe {key}: {off} hits off the plain run's, "
                                 f"{ties} near-ties")
    ok = (loss_err <= LOSS_REL and head_err <= FEATURE_REL and logit_err <= FEATURE_REL
          and all(torch.isfinite(v).all().item() for v in logits.values()))
    print(f"linear probe vs the plain versions: losses {loss_err:.3e} rel (limit {LOSS_REL:g}), "
          f"heads' change {head_err:.3e} and logits {logit_err:.3e} of max|ref| (limit "
          f"{FEATURE_REL:g}), hit counts off by at most {worst} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the linear probe disagrees with the plain run")
    return counts


def run_text_intermediates(gen, model):
    """Text intermediates on the VTP-L text tower (12 x 768, causal, no
    ``embed_cls``) at B = TEXT_BATCH, 77 tokens:
    ``text_forward_intermediates(indices=4, normalize_intermediates=True)``
    and the forward of a ``prune_intermediate_layers(indices=4)`` copy, both
    in bf16, counted (the fused causal launches, text depth each) and held
    within 5e-2 of max|ref| to the same on the plain versions. Returns the
    launches."""
    import torch

    from vtp_tpu_torch.models.text_encoder import (
        prune_intermediate_layers,
        text_forward_intermediates,
    )
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME

    cfg = model.config
    tower = model.text
    tokens = torch.randint(1, cfg.text_vocab_size - 1, (TEXT_BATCH, cfg.text_context_length),
                           generator=gen, device="cuda")
    pruned, pcfg, take = prune_intermediate_layers(tower, 4)

    @torch.no_grad()
    def run():
        out = text_forward_intermediates(tower, tokens, 4, normalize_intermediates=True,
                                         compute_dtype=torch.bfloat16)
        return [*out["text_intermediates"], out["text_features"],
                pruned(tokens, compute_dtype=torch.bfloat16)]

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {ARM_NAME[torch.bfloat16]: cfg.text_depth + pcfg.layers}
    print(f"text intermediates VTP-L text B={TEXT_BATCH} L={cfg.text_context_length}: layers "
          f"{take} of {cfg.text_depth}, pruned copy {pcfg.layers} layers, {run_s * 1e3:.2f} ms "
          f"(host clock, one run); kernel launches {counts} (expected {want})", flush=True)
    if counts != want or tower.cfg.layers != cfg.text_depth:
        raise AssertionError(f"text intermediates launches {counts}, expected {want}")
    with plain_kernels():
        ref = run()
    torch.cuda.synchronize()
    err = max(_rel_err(a, b) for a, b in zip(got, ref))
    ok = err <= FEATURE_REL and all(torch.isfinite(t).all().item() for t in got)
    print(f"text intermediates vs the plain versions: max err {err:.3e} of max|ref| (limit "
          f"{FEATURE_REL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the text intermediates disagree with the plain run")
    return counts


def run_extras(gen, model):
    """``models/extras.py`` at VTP-L widths on a context of EXTRAS_CONTEXT
    seeded 1024-wide tokens (the trunk's width), EXTRAS_BATCH rows: a bf16
    ``MultimodalTransformer`` at the text tower's width (768, 12 heads of 64,
    depth EXTRAS_DEPTH) over the context projected to 768 in the phase and
    77 seeded text tokens, whose masked self-attention and cross-attention
    take the plain path as in JAX (no launch); a bf16 ``CustomTransformer``
    (1024 wide, 16 heads of 64, depth EXTRAS_DEPTH) over the context,
    strided ``flash_attention`` at every layer; an ``AttentionalPooler``
    (256 queries, fp32: no launch). Weights from ``reset_parameters`` on the
    seeded generator. Each counted and held within 5e-2 of max|ref| to the
    same on the plain versions. Returns the launches."""
    import torch

    from vtp_tpu_torch.models.extras import (
        AttentionalPooler,
        CustomTransformer,
        MultimodalTransformer,
    )
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import FLASH_NAME

    cfg = model.config
    trunk_w, text_w = cfg.vision_embed_dim, cfg.text_embed_dim
    context = torch.randn((EXTRAS_BATCH, EXTRAS_CONTEXT, trunk_w), generator=gen, device="cuda")
    proj = torch.randn((trunk_w, text_w), generator=gen, device="cuda") * trunk_w ** -0.5
    text = torch.randn((EXTRAS_BATCH, cfg.text_context_length, text_w), generator=gen,
                       device="cuda")
    towers = {
        "multimodal": (MultimodalTransformer(text_w, EXTRAS_DEPTH, cfg.text_num_heads,
                                             output_dim=text_w,
                                             context_length=cfg.text_context_length,
                                             device="cuda"),
                       lambda m: m(context @ proj, text, torch.bfloat16), {}),
        "custom": (CustomTransformer(trunk_w, EXTRAS_DEPTH, cfg.vision_num_heads, device="cuda"),
                   lambda m: m(context, None, torch.bfloat16), {FLASH_NAME: EXTRAS_DEPTH}),
        "pooler": (AttentionalPooler(text_w, trunk_w, cfg.text_num_heads, n_queries=256,
                                     device="cuda"),
                   lambda m: m(context), {}),
    }
    counts = {}
    for name, (tower, fn, want) in towers.items():
        tower.reset_parameters(gen)
        with torch.no_grad():
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = fn(tower)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            got = launch_counts()
            with plain_kernels():
                ref = fn(tower)
        err = _rel_err(out, ref)
        ok = got == want and err <= FEATURE_REL and torch.isfinite(out).all().item()
        print(f"extras {name}: out {tuple(out.shape)} {out.dtype}, {run_s * 1e3:.2f} ms (host "
              f"clock, one run, the first call); kernel launches {got} (expected {want}); vs the "
              f"plain versions {err:.3e} of max|ref| (limit {FEATURE_REL:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"extras {name}: launches {got} (expected {want}), err {err:.3e}")
        for k, n in got.items():
            counts[k] = counts.get(k, 0) + n
    return counts


class _RecordingTokenizer:
    """A tokenizer that keeps every latent batch it encodes (to hold the
    shards read back against what was written)."""

    def __init__(self, tokenizer):
        self.tokenizer, self.latents = tokenizer, []

    def encode_images(self, images):
        z = self.tokenizer.encode_images(images)
        self.latents.append(z.cpu().numpy())
        return z


def gen_extract(gen, tokenizer, lat_dir):
    """Phase 6c, step 1: extraction through ``extract_latent_shards`` on
    in-memory batches (images, flipped images, labels), counted, the shards
    and statistics read back bit for bit, the latents against the plain
    versions. Returns the launch counts."""
    import numpy as np
    import torch

    from vtp_tpu_torch.generation.latents import (
        compute_latent_stats,
        list_latent_shards,
        load_latent_shards,
        load_latent_stats,
    )
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME
    from vtp_tpu_torch.tools.extract_latents import extract_latent_shards

    size = tokenizer.img_size
    images = torch.randn((GEN_IMAGES, 3, size, size), generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (GEN_IMAGES,), generator=gen, device="cuda")
    batches = [(images[i:i + GEN_BATCH], images[i:i + GEN_BATCH].flip(-1),
                labels[i:i + GEN_BATCH]) for i in range(0, GEN_IMAGES, GEN_BATCH)]
    recorder = _RecordingTokenizer(tokenizer)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    paths = extract_latent_shards(recorder, batches, lat_dir, shard_size=GEN_SHARD, log_every=0)
    extract_s = time.perf_counter() - t0
    counts = launch_counts()
    depth = tokenizer.config.vision_depth
    want = {ARM_NAME[torch.bfloat16]: 2 * (GEN_IMAGES // GEN_BATCH) * depth}
    print(f"generation: extraction of {GEN_IMAGES} images (+ flips) at B={GEN_BATCH} into "
          f"{len(paths)} shards in {extract_s:.3f} s (host clock, shard writes included); "
          f"launches {counts} (expected {want})", flush=True)
    if counts != want or len(paths) != GEN_IMAGES // GEN_SHARD:
        raise AssertionError(f"extraction launches {counts} / shards {len(paths)}")

    t0 = time.perf_counter()
    mean, std = compute_latent_stats(lat_dir)
    stats_s = time.perf_counter() - t0
    back = list(load_latent_shards(lat_dir))
    written = recorder.latents
    same = (list_latent_shards(lat_dir) == paths and all(
        np.array_equal(s["latents"], written[2 * i]) and np.array_equal(s["latents_flip"],
                                                                         written[2 * i + 1])
        and np.array_equal(s["labels"], labels[i * GEN_BATCH:(i + 1) * GEN_BATCH].cpu().numpy())
        for i, s in enumerate(back)))
    m2, s2 = load_latent_stats(lat_dir)
    same = same and np.array_equal(m2, mean) and np.array_equal(s2, std)
    print(f"generation: shards and stats read back bit for bit {'ok' if same else 'FAIL'} "
          f"(stats in {stats_s:.3f} s; mean in [{mean.min():.4f}, {mean.max():.4f}], std in "
          f"[{std.min():.4f}, {std.max():.4f}])", flush=True)
    if not same:
        raise AssertionError("the latent shards or statistics read back differ")

    with plain_kernels():
        refs = [tokenizer.encode_images(x).cpu().numpy() for b in batches for x in b[:2]]
    err = max(float(np.abs(z - r).max() / np.abs(r).max()) for z, r in zip(written, refs))
    ok = err <= FEATURE_REL and all(np.isfinite(z).all() for z in written)
    print(f"generation: extracted latents vs plain versions: max err {err:.3e} of max|ref| "
          f"(limit {FEATURE_REL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the extracted latents disagree with the plain-version run")
    return counts


def expected_dit_step_launches(depth, remat):
    """Launches of one DiT step over GEN_ACCUM microbatches: the forward's
    qk-norm arm once a block a microbatch, again in the backward unless the
    policy saves its output; the backward's arm once a block a microbatch."""
    from vtp_tpu_torch.ops.flash_attention import NORM_BWD_NAME, NORM_NAME

    fwd = 1 if remat in (False, "attn", "dots_attn") else 2
    return {NORM_NAME: fwd * GEN_ACCUM * depth, NORM_BWD_NAME: GEN_ACCUM * depth}


def gen_train(gen, lat_dir):
    """Phase 6c, step 2: DiT-XL/1 fed by ``LatentShardDataset`` for
    GEN_TRAIN_STEPS steps (bf16 accumulators and moments, remat "attn"),
    counted and timed, against the same steps on the plain versions; then
    one step each at "full" and "dots", counted. Returns the counts and the
    state."""
    import dataclasses

    import torch

    from vtp_tpu_torch.dit.model import make_dit_config
    from vtp_tpu_torch.dit.train import (
        DiTTrainConfig,
        LatentShardDataset,
        build_dit_train_step,
        init_dit_state,
    )
    from vtp_tpu_torch.models.initializers import normal_
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts

    cfg = make_dit_config("DiT-XL/1")
    tcfg = DiTTrainConfig(total_steps=1000, accum_steps=GEN_ACCUM, accum_dtype="bf16",
                          moment_dtype="bf16", remat="attn")
    state = init_dit_state(cfg, tcfg, gen, device="cuda")
    with torch.no_grad():  # a fresh DiT predicts 0 and passes its attention no gradient
        for lin in [b.ada for b in state.model.blocks] + [state.model.final.ada,
                                                          state.model.final.proj]:
            normal_(lin.weight, 0.02, gen)
            normal_(lin.bias, 0.02, gen)
        state.ema.load_state_dict(state.model.state_dict())
    stream = LatentShardDataset(lat_dir, seed=SEED, device="cuda").batches(GEN_BATCH)
    batches = [next(stream) for _ in range(GEN_TRAIN_STEPS + 2)]

    def split(z, y):
        return z.reshape(GEN_ACCUM, -1, *z.shape[1:]), y.reshape(GEN_ACCUM, -1)

    step = build_dit_train_step(cfg, tcfg)
    # the plain run first, from a copy freed before the counted steps, so
    # that their peak memory is the trainer's own
    plain_state = copy.deepcopy(state)
    with plain_kernels():
        plain = [step(plain_state, *split(*batches[i]), torch.Generator("cuda").manual_seed(i))[1]
                 for i in range(GEN_TRAIN_STEPS)]
    del plain_state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total, metrics, times = {}, [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(GEN_TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, *split(*batches[i]), torch.Generator("cuda").manual_seed(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = launch_counts()
        want = expected_dit_step_launches(cfg.depth, "attn")
        print(f"generation: DiT-XL/1 step {i + 1} (B={GEN_BATCH} as {GEN_ACCUM} x "
              f"{GEN_BATCH // GEN_ACCUM}, bf16 accumulators and moments, remat attn) "
              f"{times[-1] * 1e3:.1f} ms; launches {counts} (expected {want})", flush=True)
        if counts != want:
            raise AssertionError(f"DiT step launches {counts}, expected {want}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        metrics.append(m)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(m.dtype != torch.bfloat16 for m in state.optimizer.mu.values()):
        raise AssertionError("the Adam moments are not bf16")
    for i in range(GEN_TRAIN_STEPS):
        _hold_metrics(f"generation step {i + 1}", metrics[i], plain[i],
                      {"loss/transport": LOSS_REL, "loss/mse": LOSS_REL, "loss/cos": LOSS_REL,
                       "grad_norm": 2e-2})
    print(f"generation: DiT-XL/1 bf16-accumulator step on {GEN_BATCH} latents: "
          f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms (host clock); peak memory "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)", flush=True)

    for j, remat in enumerate(("full", "dots")):
        other = build_dit_train_step(cfg, dataclasses.replace(tcfg, remat=remat))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, m = other(state, *split(*batches[GEN_TRAIN_STEPS + j]),
                         torch.Generator("cuda").manual_seed(10 + j))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        counts = launch_counts()
        want = expected_dit_step_launches(cfg.depth, remat)
        print(f"generation: one step at remat {remat!r}: {step_s * 1e3:.1f} ms, loss "
              f"{m['loss/transport'].item():.5f}; launches {counts} (expected {want})",
              flush=True)
        if counts != want or not all(math.isfinite(v.item()) for v in m.values()):
            raise AssertionError(f"the {remat!r} step launched {counts}, expected {want}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total, state


def gen_checkpoint(lat_dir, out_dir):
    """Phase 6c, step 3: ``tools/train_dit.py``'s ``main`` in process at
    DiT-XL/1 cut to depth GEN_CKPT_DEPTH: GEN_TRAIN_STEPS steps and a
    checkpoint, the restore checked bit for bit, ``--resume`` for one more
    step against an uninterrupted run's; write and read timed. Returns the
    launch counts of the three runs and the checkpoint directory."""
    import shutil

    import torch

    from vtp_tpu_torch.checkpoint import (
        restore_train_state,
        save_train_state,
        train_state_tensors,
    )
    from vtp_tpu_torch.dit.model import make_dit_config
    from vtp_tpu_torch.dit.train import DiTTrainConfig, init_dit_state
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.tools import train_dit

    ckpt, straight = os.path.join(out_dir, "dit"), os.path.join(out_dir, "dit_straight")
    args = ["--latent_dir", lat_dir, "--preset", "DiT-XL/1", "--depth", str(GEN_CKPT_DEPTH),
            "--batch_size", str(GEN_BATCH), "--accum_steps", str(GEN_ACCUM), "--accum_dtype",
            "bf16", "--moment_dtype", "bf16", "--log_every", "1", "--seed", str(SEED),
            "--device", "cuda"]
    n = GEN_TRAIN_STEPS
    reset_launch_counts()
    first = train_dit.main(args + ["--steps", str(n), "--ckpt_every", str(n), "--out", ckpt])
    resumed = train_dit.main(args + ["--steps", str(n + 1), "--resume", "--out", ckpt])
    whole = train_dit.main(args + ["--steps", str(n + 1), "--out", straight])
    shutil.rmtree(straight)  # its metrics are what is held; its checkpoint is not read
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: (2 * n + 2) * v  # n steps, 1 resumed, n + 1 uninterrupted
            for k, v in expected_dit_step_launches(GEN_CKPT_DEPTH, "attn").items()}
    print(f"generation: tools/train_dit.py main at depth {GEN_CKPT_DEPTH}: {n} steps, "
          f"--resume to {n + 1}, and {n + 1} uninterrupted; launches {counts} "
          f"(expected {want})", flush=True)
    if counts != want or resumed["start_step"] != n:
        raise AssertionError(f"train_dit launches {counts} / resumed at "
                             f"{resumed['start_step']}")

    cfg = make_dit_config("DiT-XL/1", depth=GEN_CKPT_DEPTH)
    tcfg = DiTTrainConfig(total_steps=n, moment_dtype="bf16")
    saved = first["state"]
    template = init_dit_state(cfg, tcfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_train_state(ckpt, template, step=n)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    a, b = train_state_tensors(saved), train_state_tensors(template)
    same = (a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
            and template.step == saved.step == n and template.optimizer.count == n)
    n_bytes = os.path.getsize(os.path.join(ckpt, f"step_{n:08d}", "train_state.safetensors"))
    t0 = time.perf_counter()
    save_train_state(os.path.join(out_dir, "timed"), saved, block=True)
    write_s = time.perf_counter() - t0
    shutil.rmtree(os.path.join(out_dir, "timed"))
    print(f"generation: train state of {n_bytes / 1e9:.3f} GB (DiT-XL/1 at depth "
          f"{GEN_CKPT_DEPTH}, bf16 moments) written in {write_s:.2f} s, read into a template in "
          f"{read_s:.2f} s (host clock, warm page cache); restored state bit for bit "
          f"{'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("the restored train state differs from the saved one")
    _hold_metrics(f"generation resumed step {n + 1}", resumed["metrics"][0],
                  whole["metrics"][n], {"loss/transport": LOSS_REL, "loss/mse": LOSS_REL,
                                        "loss/cos": LOSS_REL, "grad_norm": 2e-2})
    exact = all(resumed["metrics"][0][k] == whole["metrics"][n][k] for k in whole["metrics"][n])
    print(f"generation: resumed step {n + 1} bit-equal to the uninterrupted one: {exact}",
          flush=True)
    return counts, ckpt


def gen_sample(model_state, tokenizer, lat_dir, ckpt):
    """Phase 6c, step 4: ``tools/sample_dit.py``'s ``sample_batches`` at
    GEN_SAMPLE_STEPS euler steps and cfg GEN_CFG on the DiT-XL/1 EMA of
    step 2, decoded by the tokenizer, counted, its latents against the plain
    versions; then the same on the EMA restored from step 3's depth-cut
    checkpoint, counted. Returns the launch counts of both."""
    import numpy as np
    import torch

    from vtp_tpu_torch.checkpoint import restore_train_state
    from vtp_tpu_torch.dit.model import make_dit_config
    from vtp_tpu_torch.dit.train import DiTTrainConfig, init_dit_state
    from vtp_tpu_torch.generation.latents import load_latent_stats
    from vtp_tpu_torch.ops.dispatch import launch_counts, reset_launch_counts
    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, NORM_NAME
    from vtp_tpu_torch.tools.sample_dit import sample_batches

    stats = load_latent_stats(lat_dir)
    kw = dict(num_samples=GEN_SAMPLES, batch_size=GEN_SAMPLES, num_steps=GEN_SAMPLE_STEPS,
              cfg_scale=GEN_CFG, seed=SEED)
    decode_depth = tokenizer.config.decoder_depth

    def run(ema, label):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        ((z, images),) = list(sample_batches(ema, tokenizer, stats, **kw))
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        counts = launch_counts()
        want = {NORM_NAME: GEN_SAMPLE_STEPS * 2 * ema.config.depth,
                ARM_NAME[torch.float32]: decode_depth}
        size = tokenizer.img_size
        print(f"generation: {label}: {GEN_SAMPLES} images, {GEN_SAMPLE_STEPS} euler steps at "
              f"cfg {GEN_CFG}, decoded, in {sample_s:.3f} s (host clock); launches {counts} "
              f"(expected {want})", flush=True)
        if counts != want or tuple(images.shape) != (GEN_SAMPLES, size, size, 3) or \
                images.dtype != torch.uint8:
            raise AssertionError(f"{label}: launches {counts}, images {tuple(images.shape)} "
                                 f"{images.dtype}")
        return counts, z

    counts, z = run(model_state.ema, "sample_batches on the DiT-XL/1 EMA")
    with plain_kernels():
        ((z_ref, _),) = list(sample_batches(model_state.ema, tokenizer, stats, **kw))
    err = ((z - z_ref).abs().max() / z_ref.abs().max()).item()
    ok = err <= FEATURE_REL and torch.isfinite(z).all().item()
    print(f"generation: sampled latents vs plain versions: max err {err:.3e} of max|ref| "
          f"(limit {FEATURE_REL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the sampled latents disagree with the plain-version run")

    cfg = make_dit_config("DiT-XL/1", depth=GEN_CKPT_DEPTH)
    template = init_dit_state(cfg, DiTTrainConfig(total_steps=1), device="cuda")
    restored = restore_train_state(ckpt, template, allow_dtype_mismatch=True)
    more, _ = run(restored.ema, f"sample_batches on the EMA restored at depth {GEN_CKPT_DEPTH}")
    return {k: counts.get(k, 0) + more.get(k, 0) for k in counts.keys() | more.keys()}


def run_generation_pipeline(gen, model):
    """Phase 6c: the generation pipeline, image batches -> latent shards ->
    DiT training -> train-state checkpoints -> samples, on the VTP-L model
    written with ``save_hf_checkpoint`` and read back by
    ``VTPTokenizer.from_checkpoint`` (checked bit for bit), all in a
    temporary directory. Returns the launch counts of the counted runs."""
    import shutil
    import tempfile

    import torch

    from vtp_tpu_torch.convert import save_hf_checkpoint
    from vtp_tpu_torch.generation import VTPTokenizer

    n_bytes = sum(t.numel() * 4 for t in model.state_dict().values())
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    if free < 2 * n_bytes:  # at most the VTP-L checkpoint, or 3 depth-cut train states
        raise AssertionError(f"{tmp} has {free / 1e9:.1f} GB free; the phase needs "
                             f"{2 * n_bytes / 1e9:.1f} GB")
    totals = {}
    with tempfile.TemporaryDirectory() as d:
        vtp_dir = os.path.join(d, "vtp")
        save_hf_checkpoint(vtp_dir, model)
        tokenizer = VTPTokenizer.from_checkpoint(vtp_dir, device="cuda",
                                                 img_size=model.config.image_size)
        shutil.rmtree(vtp_dir)
        if not _same_state(model, tokenizer.model):
            raise AssertionError("VTPTokenizer.from_checkpoint differs from the saved model")
        print("generation: VTPTokenizer.from_checkpoint on the VTP-L checkpoint, state bit for "
              "bit ok", flush=True)
        lat_dir = os.path.join(d, "latents")
        t0 = time.perf_counter()
        runs = [gen_extract(gen, tokenizer, lat_dir)]
        counts, state = gen_train(gen, lat_dir)
        runs.append(counts)
        counts, ckpt = gen_checkpoint(lat_dir, d)
        runs.append(counts)
        runs.append(gen_sample(state, tokenizer, lat_dir, ckpt))
        del state
        torch.cuda.empty_cache()
        print(f"generation pipeline: all steps in {time.perf_counter() - t0:.1f} s", flush=True)
    for run in runs:
        for k, n in run.items():
            totals[k] = totals.get(k, 0) + n
    return totals


def profile_run(label: str, fn) -> None:
    """Phase 6 (--profile): device time of one call of ``fn`` by kernel, by
    kind of kernel, and the device's idle share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    kinds = {}
    for name, (ms, _) in by_name.items():
        kind = ("fused attention" if "fused_qkv_rope_attention" in name else
                "flash attention" if "flash_attention_kernel" in name else
                "attention backward" if "attention_bwd" in name else
                "fused CE" if "fused_ce" in name else
                "GEMM" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass")) else
                "elementwise and other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print(f"profile {label}: wall {wall_ms:.2f} ms (under the profiler), device busy "
          f"{busy_ms:.2f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}: {kind:22s} {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%", flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"profile {label}: {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{n:<4d} {name[:90]}",
              flush=True)


def main() -> int:
    start = time.perf_counter()
    timer = threading.Timer(WATCHDOG_S, _watchdog)
    timer.daemon = True
    timer.start()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from vtp_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card_line = smi.splitlines()[0]
    print(f"card: {card_line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; python {sys.version.split()[0]}", flush=True)
    profiling = "--profile" in sys.argv[1:]

    _set_phase("build")
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"built {os.path.basename(lib._name)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.nvcc_path()})", flush=True)
    check_ptxas(_build.ptxas_report())
    check_sass(lib._name)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _set_phase("kernel vs plain")
    errs = check_kernel(gen)
    errs.update(check_train_kernels(gen))
    errs.update(check_dit_kernels(gen))
    errs.update(check_flash_kernels(gen))

    _set_phase("roundtrip")
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    counts, rt_s, model, images = run_roundtrip(gen)
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != prev_tf32:
        raise AssertionError("the decode did not restore the TF32 settings")
    print(f"roundtrip VTP-L 256px B={BATCH} on {card_line}: {rt_s * 1e3:.2f} ms, "
          f"{BATCH / rt_s:.2f} images/s (host clock, median of 5)", flush=True)
    if profiling:
        _set_phase("profile roundtrip")
        profile_run("roundtrip", lambda: model.get_latents_decoded_images(
            model.get_reconstruction_latents(images)))
    _set_phase("high roundtrip")
    high_counts = run_high_roundtrip(model, images, rt_s)
    if profiling:
        _set_phase("profile high roundtrip")
        profile_run("high roundtrip", lambda: model.get_latents_decoded_images(
            model.get_reconstruction_latents(images), precision="high"))
    _set_phase("serve")
    serve_counts = run_serve(model, card_line)
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != prev_tf32:
        raise AssertionError("the decodes did not restore the TF32 settings")
    torch.cuda.empty_cache()
    _set_phase("int8 serving")
    t0 = time.perf_counter()
    int8_counts = run_int8_serving(model, images, card_line, profiling)
    torch.cuda.empty_cache()
    run_bench_serve(card_line)
    torch.cuda.empty_cache()
    print(f"int8 serving and bench_serve: {time.perf_counter() - t0:.1f} s", flush=True)
    _set_phase("head-major")
    hm_counts, hm_model = run_head_major(model, images, rt_s)
    if profiling:
        _set_phase("profile head-major roundtrip")
        profile_run("head-major roundtrip", lambda: hm_model.get_latents_decoded_images(
            hm_model.get_reconstruction_latents(images)))
    del hm_model
    _set_phase("non-causal text")
    text_counts = run_text(gen, model)
    _set_phase("off-gate head dim 72")
    run_off_gate(gen)
    _set_phase("reconstruction eval")
    eval_counts = run_recon_eval(gen, model)
    _set_phase("zero-shot eval")
    zs_counts = run_zero_shot(gen, model)
    _set_phase("linear probe")
    probe_counts = run_linear_probe(gen, model)
    torch.cuda.empty_cache()
    _set_phase("text intermediates")
    ti_counts = run_text_intermediates(gen, model)
    _set_phase("extras")
    extras_counts = run_extras(gen, model)
    del images
    torch.cuda.empty_cache()
    _set_phase("dit latents")
    tokenizer, latents, latent_stats = dit_latents(gen, model)
    print(f"dit latents: {tuple(latents.shape)} from VTPTokenizer.encode_images on VTP-L",
          flush=True)
    del model
    torch.cuda.empty_cache()

    _set_phase("train step")
    train_counts, samples, peak_gb, state, batch, step = run_train(gen)
    step_s = statistics.median(samples)
    print(f"train step VTP-L CLIP+SSL+rec B={BATCH} (2x256² + 4x96² SSL crops an image) on "
          f"{card_line}: {step_s * 1e3:.2f} ms a step, {BATCH / step_s:.2f} images/s (host clock, "
          f"median of {len(samples)}: {', '.join(f'{x * 1e3:.1f}' for x in samples)} ms); "
          f"peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated)", flush=True)
    if profiling:
        _set_phase("profile train step")
        profile_run("train step", lambda: step(state, batch))
    del state, batch, step
    torch.cuda.empty_cache()

    # its own generator: the later phases draw what they drew before it
    _set_phase("vtp training")
    vtp_counts = run_vtp_training(torch.Generator(device="cuda").manual_seed(SEED + 1),
                                  card_line)
    torch.cuda.empty_cache()

    # its own seeds: the later phases draw what they drew before it
    _set_phase("parallel")
    parallel_counts = run_parallel(card_line)
    torch.cuda.empty_cache()
    _set_phase("context and pipeline parallel")
    cp_pp_counts = run_cp_pp(card_line)
    torch.cuda.empty_cache()

    _set_phase("dit train step")
    dit_counts, samples, peak_gb, state, labels, draws, step = run_dit_train(gen, latents)
    step_s = statistics.median(samples)
    print(f"dit train step DiT-XL/1 B={DIT_BATCH} (16x16x64 latents, bf16, remat on) on "
          f"{card_line}: {step_s * 1e3:.2f} ms a step, {DIT_BATCH / step_s:.2f} samples/s (host "
          f"clock, median of {len(samples)}: {', '.join(f'{x * 1e3:.1f}' for x in samples)} ms); "
          f"peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated)", flush=True)
    if profiling:
        _set_phase("profile dit train step")
        profile_run("dit train step", lambda: step(state, latents, labels, gen, draws))
    del step, draws
    torch.cuda.empty_cache()

    _set_phase("sampling")
    sample_counts, sample_s = run_sampling(gen, state, tokenizer, latent_stats)
    print(f"sampling DiT-XL/1 {SAMPLE_BATCH} images, {SAMPLE_STEPS} euler steps, cfg 1.0, VTP-L "
          f"decode on {card_line}: {sample_s:.3f} s, {SAMPLE_BATCH / sample_s:.3f} images/s, "
          f"{sample_s / SAMPLE_STEPS * 1e3:.2f} ms an euler step with the decode spread over them "
          f"(host clock, one run)", flush=True)
    _set_phase("int8 sampling")
    t0 = time.perf_counter()
    int8_sample_counts = run_int8_sampling(gen, state, tokenizer, latent_stats, sample_s,
                                           card_line)
    print(f"int8 sampling: {time.perf_counter() - t0:.1f} s", flush=True)
    del state
    torch.cuda.empty_cache()

    # its own generator: the later phases draw what they drew before it
    _set_phase("generation pipeline")
    gen_counts = run_generation_pipeline(torch.Generator(device="cuda").manual_seed(SEED),
                                         tokenizer.model)
    del tokenizer
    torch.cuda.empty_cache()

    _set_phase("head dims 32 and 128")
    t0 = time.perf_counter()
    check_head_dim_edges()
    head_dim_counts = []
    for d in (32, 128):
        head_dim_counts.append(run_head_dim_vtp(gen, d))
        head_dim_counts.append(run_head_dim_dit(gen, d, latents))
    print(f"head dims 32 and 128: edges and runs in {time.perf_counter() - t0:.1f} s", flush=True)
    del latents
    torch.cuda.empty_cache()

    # its own seeds: the phases before it drew what they drew before
    _set_phase("fsdp zero3, int8 tp, probe")
    zero3_counts = run_zero3(card_line)
    torch.cuda.empty_cache()

    # launches: each arm's count summed over the main paths' runs (one
    # roundtrip, one high roundtrip, the serve run, the int8 serving phase's
    # counted runs, the int8 sampling phase's, one head-major roundtrip,
    # one non-causal text call, the reconstruction and zero-shot evals, the
    # linear probe, the text intermediates, the extras, one train step, the
    # VTP training phase's counted runs, the parallel phases' counted runs (rank
    # 0 of the two-rank arms), one DiT train step, one 250-step
    # sample, the generation pipeline's counted runs, and at head dims 32
    # and 128 one roundtrip, high decode, train step, DiT train step and
    # 4-step sample each)
    for run in (high_counts, serve_counts, int8_counts, int8_sample_counts, hm_counts,
                text_counts, eval_counts, zs_counts,
                probe_counts, ti_counts, extras_counts, train_counts, vtp_counts, parallel_counts,
                cp_pp_counts, dit_counts, sample_counts, gen_counts, *head_dim_counts,
                zero3_counts):
        for name, n in run.items():
            counts[name] = counts.get(name, 0) + n
    _set_phase("timing")
    rows = time_kernels(gen, card_line, errs, counts)
    rows += time_train_kernels(gen, card_line, errs, counts)
    rows += time_dit_kernels(gen, card_line, errs, counts)
    rows += time_flash_kernels(gen, card_line, errs, counts)
    rows += time_head_dim_kernels(gen, card_line, counts)
    time_tp_kernels(gen, card_line)

    kind = torch.cuda.get_device_name(0)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
