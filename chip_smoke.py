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
4. runs the VTP-L CLIP+SSL+rec train step (``init_state``,
   ``build_train_step``; B = 8 images, each with a CLIP pair, a
   reconstruction target and 2 global + 4 local SSL crops) once on the
   kernels, counting their launches, and the same step from the same state
   and batch on the plain versions; compares the losses and the grad norm,
   checks that the state moved, then times steps (images/s, peak memory);
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
   a 4-step sample's latents against the same on the plain versions;
7. times each kernel arm against its plain version, a PyTorch yardstick
   call where there is one, and its bound, each by CUDA events twice: as
   the host issues the calls (``ms``, ``plain_ms``, ``library_ms``: a short
   kernel behind a Python wrapper reads the host's cost of a call) and
   queued behind a device sleep (``device_ms``, ``plain_device_ms``,
   ``library_device_ms``: the device's time alone); and the roundtrip's
   images/s;
8. with --profile, traces one roundtrip, one train step and one DiT train
   step with torch.profiler and prints the device time by kernel and the
   device's idle share.

Prints the card's name and power limit, one JSON line {"kernels": [...]} and,
as the last line, {"ok": true, "device": {...}}. Exits non-zero, with no
result line, when there is no CUDA device, when the package is missing or
when any phase fails. A watchdog ends the run if it outlasts WATCHDOG_S.
"""

from __future__ import annotations

import contextlib
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

WATCHDOG_S = 900
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


@contextlib.contextmanager
def _plain_kernels():
    """Run the model on the kernels' plain versions (the comparison runs): the
    differentiable attention and CE keep their autograd Functions, whose
    forward and backward then go to the plain PyTorch versions."""
    from vtp_tpu_torch.ops import flash_attention as fa
    from vtp_tpu_torch.ops import fused_ce

    saved = (fa._forward, fa.fused_qkv_rope_attention_bwd,
             fa.fused_qkv_rope_attention_qk_norm_bwd, fa._flash_bnhd_forward, fa._flash_forward,
             fused_ce.fused_ce_fwd, fused_ce.fused_ce_bwd)
    fa._forward = fa.fused_qkv_rope_attention_reference
    fa.fused_qkv_rope_attention_bwd = fa.fused_qkv_rope_attention_bwd_reference
    fa.fused_qkv_rope_attention_qk_norm_bwd = fa.fused_qkv_rope_attention_qk_norm_bwd_reference
    fa._flash_bnhd_forward = fa.flash_attention_bnhd_reference
    fa._flash_forward = fa.flash_attention_reference
    fused_ce.fused_ce_fwd = fused_ce.fused_ce_fwd_reference
    fused_ce.fused_ce_bwd = fused_ce.fused_ce_bwd_reference
    try:
        yield
    finally:
        (fa._forward, fa.fused_qkv_rope_attention_bwd, fa.fused_qkv_rope_attention_qk_norm_bwd,
         fa._flash_bnhd_forward, fa._flash_forward, fused_ce.fused_ce_fwd,
         fused_ce.fused_ce_bwd) = saved


def _attention_inputs(gen, B, N, H, dtype, grid, prefix, qk_norm=False):
    import torch

    from vtp_tpu_torch.ops.rope import pad_rope_prefix, rope_periods_init, rope_sincos

    qkv = torch.randn((B, N, 3 * H * 64), generator=gen, device="cuda").to(dtype)
    rope = (None, None)
    if grid:
        rope = pad_rope_prefix(*rope_sincos(rope_periods_init(64, device="cuda"), grid, grid), prefix)
    scales = (None, None)
    if qk_norm:
        scales = tuple(1.0 + 0.1 * torch.randn(64, generator=gen, device="cuda") for _ in range(2))
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
    unless the exact fp32 arm's kernel is there with FFMAs and without a
    tensor-core instruction (any opcode with MMA in it: HMMA, HGMMA, IMMA,
    DMMA, ...)."""
    import re

    from vtp_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    bodies = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        bodies[name.strip()] = body
    names = [n for n in bodies if "fused_qkv_rope_attention_f32_kernel" in n]
    if len(names) != 1:
        raise AssertionError(f"the exact fp32 kernel's SASS not found once: {names}")
    ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", bodies[names[0]],
                     re.M)
    mma = sorted({op for op in ops if "MMA" in op})
    print(f"sass fused_qkv_rope_attention_f32_kernel: {len(ops)} instructions, "
          f"{ops.count('FFMA')} FFMA, tensor-core instructions {mma or 'none'} "
          f"{'FAIL' if mma or not ops.count('FFMA') else 'ok'}", flush=True)
    if mma or not ops.count("FFMA"):
        raise AssertionError(f"the exact fp32 kernel uses tensor cores or no FFMA: {mma}")


def _edge_inputs(gen, N, rope, qk_norm, B=1, H=2, dtype=None):
    """qkv (B, N, 3*H*64), bf16 unless ``dtype`` says otherwise; with
    ``rope``, (N, 64) sin/cos tables of random angles (column j and j+32
    share an angle, as rotate-half RoPE has it), for any N; with
    ``qk_norm``, (64,) scales."""
    import torch

    qkv = torch.randn((B, N, 3 * H * 64), generator=gen, device="cuda").to(dtype or torch.bfloat16)
    sin = cos = None
    if rope:
        ang = 2 * math.pi * torch.rand((N, 32), generator=gen, device="cuda")
        ang = torch.cat([ang, ang], dim=-1)
        sin, cos = ang.sin(), ang.cos()
    scales = (None, None)
    if qk_norm:
        scales = tuple(1.0 + 0.1 * torch.randn(64, generator=gen, device="cuda") for _ in range(2))
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


def check_edges_fwd():
    """The bf16 forward, with and without qk-norm, at every edge case, held
    to 1e-2 of max|ref| as the bf16 arm's main shapes, on the inputs of each
    of EDGE_SEEDS: its single sweep rounds p where the plain version does
    not, so the margin to the gate is read over several draws."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import (
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_reference,
    )

    worst = {}
    for seed in EDGE_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        worst[seed] = (0.0, "")
        for qk_norm in (False, True):
            for name, N, rope, causal, n_valid in _edge_cases():
                qkv, (sin, cos), (qs, ks) = _edge_inputs(gen, N, rope, qk_norm)
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
                    print(f"kernel edge fwd seed {seed} {name} qk_norm={qk_norm} N={N} n_valid="
                          f"{n_valid}: max abs err {err:.3e} (max|ref| {scale:.3e}; limit 1e-2 "
                          f"rel) FAIL", flush=True)
                    raise AssertionError(f"fused attention edge case {name} N={N} disagrees")
    print(f"kernel edge fwd bf16, with and without qk-norm, {2 * len(_edge_cases())} cases at N in "
          f"{EDGE_N}, each on the inputs of seeds {EDGE_SEEDS}: worst max abs err of max|ref| "
          f"(limit 1e-2) by seed: "
          + ", ".join(f"{sd}: {w:.3e} ({case})" for sd, (w, case) in worst.items()) + " ok",
          flush=True)


def check_edges_fp32(precision: str, ns) -> None:
    """An fp32 arm of the forward (``precision``: "float32", the exact arm,
    or "high", the bf16x3 arm) on fp32 inputs, with and without qk-norm, at
    every edge case at N in ``ns``, on the inputs of each of EDGE_SEEDS, at
    the fp32 arms' gates: 1e-4 abs, and 1e-2 of max|ref| where qk-norm and
    RoPE meet (an ulp of the fp32 norm can flip a bf16 rounding of RoPE, as
    in check_kernel). Both arms divide by the row's sum at the end, where
    the plain version normalises p first; the bf16x3 arm also splits the
    unnormalised p."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import (
        arm_name,
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_reference,
    )

    arm = arm_name(torch.float32, precision)
    worst = {}
    for seed in EDGE_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        worst[seed] = {"abs": (0.0, ""), "rel": (0.0, "")}
        for qk_norm in (False, True):
            for name, N, rope, causal, n_valid in _edge_cases(ns):
                qkv, (sin, cos), (qs, ks) = _edge_inputs(gen, N, rope, qk_norm,
                                                         dtype=torch.float32)
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
                    print(f"kernel edge {arm} seed {seed} {name} qk_norm={qk_norm} N={N} "
                          f"n_valid={n_valid}: max abs err {err:.3e} (max|ref| {scale:.3e}; limit "
                          f"{limit} {kind}) FAIL", flush=True)
                    raise AssertionError(f"{arm} attention edge case {name} N={N} disagrees")
    print(f"kernel edge {arm}, with and without qk-norm, {2 * len(_edge_cases(ns))} cases at N in "
          f"{ns}, each on the inputs of seeds {EDGE_SEEDS}: worst max abs err (limit 1e-4) and, "
          f"with qk-norm and RoPE, worst of max|ref| (limit 1e-2) by seed: "
          + ", ".join(f"{sd}: {w['abs'][0]:.3e} ({w['abs'][1]}) / {w['rel'][0]:.3e} "
                      f"({w['rel'][1]})" for sd, w in worst.items()) + " ok", flush=True)


def check_edges_bwd(gen, qk_norm):
    """The backward's arm (without or with qk-norm) at every edge case:
    d(qkv) within 1e-2 of max|ref|, dw_q and dw_k within 1e-2 relative."""
    import torch

    from vtp_tpu_torch.ops import flash_attention as fa

    worst = worst_dw = 0.0
    for name, N, rope, causal, n_valid in _edge_cases():
        qkv, (sin, cos), (qs, ks) = _edge_inputs(gen, N, rope, qk_norm)
        g = torch.randn((1, N, 2 * 64), generator=gen, device="cuda").bfloat16()
        if qk_norm:
            got = fa.fused_qkv_rope_attention_qk_norm_bwd(qkv, g, sin, cos, qs, ks, 2, n_valid,
                                                          causal)
            torch.cuda.synchronize()
            want = fa.fused_qkv_rope_attention_qk_norm_bwd_reference(qkv, g, sin, cos, qs, ks, 2,
                                                                     n_valid, causal)
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
            print(f"kernel edge bwd {name} qk_norm={qk_norm} N={N} n_valid={n_valid}: d(qkv) max "
                  f"abs err {err:.3e} (max|ref| {scale:.3e}; limit 1e-2 rel), dw max rel err "
                  f"{dw_err:.3e} (limit 1e-2) FAIL", flush=True)
            raise AssertionError(f"attention backward edge case {name} N={N} disagrees")
    arm = "qk-norm arm" if qk_norm else "no-norm arm"
    print(f"kernel edge bwd {arm}, {len(_edge_cases())} cases at N in {EDGE_N}: worst d(qkv) max "
          f"abs err {worst:.3e} of max|ref| (limit 1e-2)"
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

    with _plain_kernels():
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
    with _plain_kernels():
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
    with _plain_kernels():
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
    with _plain_kernels():
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
    with _plain_kernels():
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


def expected_train_launches(cfg):
    """Launches per train step at remat off. Forward (bf16 arm): the trunk on
    the CLIP images, on the rec images and in the teacher (one launch a layer
    each), the student's two crops (two a layer), the decoder and the text
    tower. Backward: the same without the no-grad teacher. CE: DINO
    globals, DINO locals, iBOT."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import ARM_NAME, BWD_NAME
    from vtp_tpu_torch.ops.fused_ce import BWD_NAME as CE_BWD
    from vtp_tpu_torch.ops.fused_ce import FWD_NAME as CE_FWD

    v, d, t = cfg.vision_depth, cfg.decoder_depth, cfg.text_depth
    return {ARM_NAME[torch.bfloat16]: 5 * v + d + t, BWD_NAME: 4 * v + d + t, CE_FWD: 3, CE_BWD: 3}


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

    with _plain_kernels():
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

    with _plain_kernels():
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
    with _plain_kernels():
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
    del state, tokenizer
    torch.cuda.empty_cache()

    # launches: each arm's count summed over the main paths' runs (one
    # roundtrip, one high roundtrip, the serve run, one head-major roundtrip,
    # one non-causal text call, one train step, one DiT train step, one
    # 250-step sample)
    for run in (high_counts, serve_counts, hm_counts, text_counts, train_counts, dit_counts,
                sample_counts):
        for name, n in run.items():
            counts[name] = counts.get(name, 0) + n
    _set_phase("timing")
    rows = time_kernels(gen, card_line, errs, counts)
    rows += time_train_kernels(gen, card_line, errs, counts)
    rows += time_dit_kernels(gen, card_line, errs, counts)
    rows += time_flash_kernels(gen, card_line, errs, counts)

    kind = torch.cuda.get_device_name(0)
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
