#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vtp_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. builds the port's CUDA kernels from ``vtp_tpu_torch/csrc`` with nvcc;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's VTP-L shapes and on small cases for every flag;
3. runs the main path once through the public API at full VTP-L width:
   ``VTPModel.init`` with seeded random weights, a batch of 8 random 256x256
   images -> bf16 latents -> exact-fp32 images; checks the outputs and that
   every kernel of the path was launched, and compares them with the same
   model run on the plain attention;
4. times each kernel arm against its plain version, the PyTorch SDPA call
   and its bound, and the roundtrip's images/s;
5. with --profile, traces one roundtrip with torch.profiler and prints the
   device time by kernel and the device's idle share.

Prints the card's name and power limit, one JSON line {"kernels": [...]} and,
as the last line, {"ok": true, "device": {...}}. Exits non-zero, with no
result line, when there is no CUDA device, when the package is missing or
when any phase fails. A watchdog ends the run if it outlasts WATCHDOG_S.
"""

from __future__ import annotations

import contextlib
import json
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


def _time_ms(fn, iters: int = 10, samples: int = 7) -> float:
    """Median over `samples` of the mean time of `iters` calls, by CUDA
    events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


@contextlib.contextmanager
def _plain_attention():
    """Run the model's blocks on the plain attention (the comparison run)."""
    from vtp_tpu_torch.models import blocks
    from vtp_tpu_torch.ops.flash_attention import fused_qkv_rope_attention_reference

    kernel = blocks.fused_qkv_rope_attention
    blocks.fused_qkv_rope_attention = fused_qkv_rope_attention_reference
    try:
        yield
    finally:
        blocks.fused_qkv_rope_attention = kernel


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


def check_kernel(gen):
    """Phase 2: the kernel against its plain version. Returns the error of
    each arm at the main path's shapes."""
    import torch

    from vtp_tpu_torch.ops.flash_attention import (
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_reference,
    )

    bf16, fp32 = torch.bfloat16, torch.float32
    # name, B, N, H, dtype, rope grid (0 = none), prefix, n_valid, causal, qk_norm, tol kind
    cases = [
        ("vtpl_encode", BATCH, 257, 16, bf16, 16, 1, 0, False, False, "rel"),
        ("vtpl_decode", BATCH, 256, 16, fp32, 16, 0, 0, False, False, "abs"),
    ]
    for dt in (bf16, fp32):
        tol = "rel" if dt is bf16 else "abs"
        cases += [
            ("n_valid", 2, 197, 4, dt, 14, 1, 190, False, False, tol),
            ("causal", 2, 197, 4, dt, 0, 0, 0, True, False, tol),
            ("causal_n_valid_rope", 2, 197, 4, dt, 14, 1, 150, True, False, tol),
            ("qk_norm", 2, 197, 4, dt, 0, 0, 0, False, True, tol),
            # the fp32 arm ropes in bf16 after an fp32 norm whose sum order
            # differs from torch's, so an ulp there can flip a bf16 rounding:
            # this case is held to the bf16 tolerance in both arms
            ("qk_norm_rope", 2, 197, 4, dt, 14, 1, 0, False, True, "rel"),
        ]
    errs = {}
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in exact fp32
    torch.backends.cudnn.allow_tf32 = False
    for name, B, N, H, dt, grid, prefix, n_valid, causal, qk_norm, tol_kind in cases:
        qkv, (sin, cos), (qs, ks) = _attention_inputs(gen, B, N, H, dt, grid, prefix, qk_norm)
        got = fused_qkv_rope_attention(qkv, sin, cos, H, qs, ks, n_valid=n_valid, is_causal=causal)
        torch.cuda.synchronize()
        want = fused_qkv_rope_attention_reference(qkv, sin, cos, H, qs, ks, n_valid=n_valid,
                                                  is_causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = (err <= 1e-2 * scale) if tol_kind == "rel" else (err <= 1e-4)
        limit = "1e-2 rel of max|ref|" if tol_kind == "rel" else "1e-4 abs"
        arm = "bf16" if dt is bf16 else "fp32"
        print(f"kernel {name:20s} {arm} B={B} N={N} H={H}: max abs err {err:.3e} "
              f"(max|ref| {scale:.3e}; limit {limit}) {'ok' if ok else 'FAIL'}", flush=True)
        if not (ok and torch.isfinite(got).all().item()):
            raise AssertionError(f"fused attention {name} ({arm}) disagrees with its plain version")
        if name.startswith("vtpl_"):
            errs[arm] = err
    return errs


def run_roundtrip(gen):
    """Phase 3: the main path at full VTP-L width, once, counted."""
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

    with _plain_attention():
        ref_latents = model.get_reconstruction_latents(images)
        ref_recon = model.get_latents_decoded_images(latents)
    torch.cuda.synchronize()
    lat_err = ((latents.float() - ref_latents.float()).abs().max()
               / ref_latents.float().abs().max()).item()
    img_err = (recon - ref_recon).abs().max().item()
    print(f"roundtrip vs plain attention: latents max err {lat_err:.3e} of max|ref| (limit 5e-2), "
          f"images max abs err {img_err:.3e} (limit 1e-3; max|ref| "
          f"{ref_recon.abs().max().item():.3e})", flush=True)
    if not (lat_err <= 5e-2 and img_err <= 1e-3):
        raise AssertionError("roundtrip disagrees with the plain-attention run")

    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.get_latents_decoded_images(model.get_reconstruction_latents(images))
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    rt_s = statistics.median(samples)
    return counts, rt_s, model, images


def time_kernels(gen, card, errs, counts):
    """Phase 4: each arm at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from vtp_tpu_torch.ops.flash_attention import (
        ARM_NAME,
        fused_qkv_rope_attention,
        fused_qkv_rope_attention_reference,
    )
    from vtp_tpu_torch.ops.rope import rope_apply

    bw, bf16_peak, fp32_peak = next((v for k, v in PEAKS.items() if k in card), PEAKS["H100"])
    H, d = 16, 64
    rows = []
    for dt, N, prefix, peak in ((torch.bfloat16, 257, 1, bf16_peak), (torch.float32, 256, 0, fp32_peak)):
        qkv, (sin, cos), _ = _attention_inputs(gen, BATCH, N, H, dt, 16, prefix)
        kern = lambda: fused_qkv_rope_attention(qkv, sin, cos, H)
        plain = lambda: fused_qkv_rope_attention_reference(qkv, sin, cos, H)
        # SDPA yardstick on pre-split, pre-roped (B, H, N, d) operands
        q, k, v = qkv.reshape(BATCH, N, 3, H, d).unbind(2)
        s, c = sin[None, :, None, :], cos[None, :, None, :]
        q = rope_apply(q.to(torch.bfloat16), s, c).to(dt).transpose(1, 2).contiguous()
        k = rope_apply(k.to(torch.bfloat16), s, c).to(dt).transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()
        lib = lambda: F.scaled_dot_product_attention(q, k, v)
        ms, plain_ms, lib_ms = _time_ms(kern), _time_ms(plain), _time_ms(lib)
        item = torch.finfo(dt).bits // 8
        nbytes = BATCH * N * (3 * H * d + H * d) * item
        flops = 4 * BATCH * H * N * N * d
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        arm = ARM_NAME[dt]
        rows.append({
            "name": arm, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": counts.get(arm, 0), "max_abs_err": errs["bf16" if dt is torch.bfloat16 else "fp32"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
        })
        print(f"timing {arm} B={BATCH} N={N} H={H} on {card}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    return rows


def profile_roundtrip(model, images) -> None:
    """Phase 5 (--profile): device time of one roundtrip by kernel, by
    kind of kernel, and the device's idle share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.get_latents_decoded_images(model.get_reconstruction_latents(images))
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
                "GEMM" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass")) else
                "elementwise and other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print(f"profile: wall {wall_ms:.2f} ms (under the profiler), device busy {busy_ms:.2f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"profile: {kind:22s} {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%", flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"profile: {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{n:<4d} {name[:90]}", flush=True)


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

    _set_phase("build")
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"built {os.path.basename(lib._name)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.nvcc_path()})", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _set_phase("kernel vs plain")
    errs = check_kernel(gen)

    _set_phase("roundtrip")
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    counts, rt_s, model, images = run_roundtrip(gen)
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != prev_tf32:
        raise AssertionError("the decode did not restore the TF32 settings")
    print(f"roundtrip VTP-L 256px B={BATCH} on {card_line}: {rt_s * 1e3:.2f} ms, "
          f"{BATCH / rt_s:.2f} images/s (host clock, median of 5)", flush=True)
    if "--profile" in sys.argv[1:]:
        _set_phase("profile")
        profile_roundtrip(model, images)
    del model, images

    _set_phase("timing")
    rows = time_kernels(gen, card_line, errs, counts)

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
