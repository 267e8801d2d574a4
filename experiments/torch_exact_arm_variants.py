#!/usr/bin/env python3
"""Where the exact fp32 attention kernel spends its time, on one NVIDIA GPU.

    python3 experiments/torch_exact_arm_variants.py

Builds variants of ``vtp_tpu_torch/csrc/fused_attention.cu``, each from a
copy of ``csrc`` with one edit, into separate libraries (nvcc, one process
each, all at once), and times each one's exact fp32 entry at the VTP-L
decode's shape (8, 256, 16 heads of 64, RoPE on a 16x16 grid) by CUDA
events queued behind a device sleep (``chip_smoke._time_ms``), in turns,
twice (the order reversed the second time), beside exact SDPA (TF32 off).
Variants named ``drop_*`` leave out one part of the kernel and compute a
wrong result: they place the time, nothing else. The others compute the
same function and are held to the plain version (1e-4 abs) at the main
shape and at N = 1, 63, 64, 65, 130 and 577 with causal, n_valid, RoPE and
qk-norm cases. Prints ptxas's registers, stack and spills of each
variant's kernel. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "vtp_tpu_torch", "csrc")
SCORES = "    scores_f32(s, q, s_k + st * kF32Tile + cg * kStride);\n"
PV = "    pv_f32(o, p_rows + rg * kPRow, s_v + st * kF32Tile + 4 * cg);\n"
EXP = "        const float p = expf(s[r][e] - base);  // 0 where masked; stays fp32\n"
BARRIER = "    __syncthreads();  // publishes step i + 1's tiles; frees stage i and the P rows\n"
PROLOGUE = """    if (next) {
      prologue_f32_tile(s_k + ((i + 1) % kF32Stages) * kF32Tile, (i + 1) * kTile, N,
                        norm ? s_w + kHeadDim : nullptr, tab, rope);
    }
"""
COPY = "    if (i < n_kt) {\n      const int st = i % kF32Stages;\n      load_f32_tile_async(s_k"
ROPE_PAIRS = """        const int i = 8 * part + 2 * e;
        const __nv_bfloat162 a = __floats2bfloat162_rn(x[i], x[i + 1]);
        const __nv_bfloat162 b = __floats2bfloat162_rn(x[16 + i], x[17 + i]);
        const float2 ac = __bfloat1622float2(__hmul2(a, ca[e]));
        const float2 bs = __bfloat1622float2(__hmul2(__hneg2(b), sa[e]));
        const float2 bc = __bfloat1622float2(__hmul2(b, cb[e]));
        const float2 as = __bfloat1622float2(__hmul2(a, sb[e]));
        const float2 ra = __bfloat1622float2(__floats2bfloat162_rn(ac.x + bs.x, ac.y + bs.y));
        const float2 rb = __bfloat1622float2(__floats2bfloat162_rn(bc.x + as.x, bc.y + as.y));
        x[i] = ra.x;
        x[i + 1] = ra.y;
        x[16 + i] = rb.x;
        x[17 + i] = rb.y;
"""
# RoPE one fp32 value at a time, each rounding a scalar bf16 round trip
ROPE_SCALAR = """        for (int h = 0; h < 2; ++h) {
          const int i = 8 * part + 2 * e + h;
          const float c_a = h ? __high2float(ca[e]) : __low2float(ca[e]);
          const float s_a = h ? __high2float(sa[e]) : __low2float(sa[e]);
          const float c_b = h ? __high2float(cb[e]) : __low2float(cb[e]);
          const float s_b = h ? __high2float(sb[e]) : __low2float(sb[e]);
          const float lo = bf16_round(x[i]), hi = bf16_round(x[16 + i]);
          x[i] = bf16_round(bf16_round(lo * c_a) + bf16_round(-hi * s_a));
          x[16 + i] = bf16_round(bf16_round(hi * c_b) + bf16_round(lo * s_b));
        }
"""
MASK_SKIP = """    if (causal || (i + 1) * kTile > n_valid) {"""
MASK_ELSE = """    } else {  // every key of the tile is valid for every row
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
#pragma unroll
        for (int e = 0; e < 8; ++e) s[r][e] *= 0.125f;
      }
    }
"""
UNROLL = ("#pragma unroll\n  for (int d", "#pragma unroll\n  for (int j")
# name: (edits, computes the kernel's function)
VARIANTS = {
    "kept": ([], True),
    "rope_scalar": ([(ROPE_PAIRS, ROPE_SCALAR)], True),
    "unroll_4": ([(u, u.replace("unroll", "unroll 4")) for u in UNROLL], True),
    "mask_always": ([(MASK_SKIP, "    {"), (MASK_ELSE, "    }\n")], True),
    "rows_8": ([("constexpr int kF32Rows = 4;", "constexpr int kF32Rows = 8;")], True),
    "drop_scores": ([(SCORES, "    for (int r = 0; r < kF32Rows; ++r)\n"
                               "      for (int e = 0; e < 8; ++e) s[r][e] = 0.01f * (e + r);\n")],
                    False),
    "drop_pv": ([(PV, "")], False),
    "drop_exp": ([(EXP, "        const float p = s[r][e] - base;\n")], False),
    "drop_barrier": ([(BARRIER, "")], False),
    "drop_k_rope": ([(PROLOGUE, "")], False),
    "drop_copies": ([(COPY, COPY.replace("i < n_kt", "i < 1"))], False),
}


def build(work: str):
    """One library per variant; returns {name: (entry, ptxas line)}."""
    from vtp_tpu_torch import _build

    procs = {}
    for name, (edits, _) in VARIANTS.items():
        d = os.path.join(work, name)
        shutil.copytree(SRC, d)
        path = os.path.join(d, "fused_attention.cu")
        text = open(path).read()
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"variant {name}: its edit no longer applies")
            text = text.replace(old, new)
        open(path, "w").write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{err}")
        lines = err.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry function" in line and "f32_kernel" in line)
        report = " ".join(line.split(":", 1)[-1].strip() for line in lines[at + 2:at + 4])
        fn = ctypes.CDLL(os.path.join(work, name, "lib.so")).vtp_fused_qkv_rope_attention_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        libs[name] = (fn, report)
    return libs


def call(fn, qkv, sin, cos, q_scale, k_scale, heads, n_valid=0, causal=False):
    import torch

    B, N, _ = qkv.shape
    out = torch.empty((B, N, heads * 64), device="cuda")
    ptr = lambda t: None if t is None else t.data_ptr()
    if sin is not None:
        sin, cos = sin.to(torch.bfloat16).contiguous(), cos.to(torch.bfloat16).contiguous()
    rc = fn(ptr(qkv), ptr(sin), ptr(cos), ptr(q_scale), ptr(k_scale), ptr(out), B, N, heads,
            n_valid or N, int(causal), torch.cuda.current_device(),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from vtp_tpu_torch.ops.flash_attention import fused_qkv_rope_attention_reference as plain
    from vtp_tpu_torch.ops.rope import rope_apply

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        libs = build(work)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for name, (fn, report) in libs.items():
            line = f"variant {name:13s} ptxas: {report}"
            if VARIANTS[name][1]:
                worst = 0.0
                for n in (1, 63, 64, 65, 130, 577):
                    for causal, n_valid, rope, qk_norm in (
                            (False, 0, True, False), (True, 0, True, False),
                            (False, max(1, 2 * n // 3), False, False),
                            (True, max(1, n // 2), True, False), (False, 0, False, True)):
                        qkv, (sin, cos), (qs, ks) = cs._edge_inputs(gen, n, rope, qk_norm,
                                                                    dtype=torch.float32)
                        got = call(fn, qkv, sin, cos, qs, ks, 2, n_valid, causal)
                        want = plain(qkv, sin, cos, 2, qs, ks, n_valid=n_valid, is_causal=causal)
                        worst = max(worst, (got - want).abs().max().item())
                line += f"; edges worst abs err {worst:.3e} {'ok' if worst <= 1e-4 else 'FAIL'}"
                if worst > 1e-4:
                    print(line, flush=True)
                    raise AssertionError(f"variant {name} disagrees with the plain version")
            print(line, flush=True)

        qkv, (sin, cos), _ = cs._attention_inputs(gen, 8, 256, 16, torch.float32, 16, 0)
        want = plain(qkv, sin, cos, 16)
        err = (call(libs["kept"][0], qkv, sin, cos, None, None, 16) - want).abs().max().item()
        print(f"kept at (8, 256, 16): max abs err {err:.3e} (limit 1e-4)", flush=True)
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                fn = libs[name][0]
                times[name].append(cs._time_ms(lambda: call(fn, qkv, sin, cos, None, None, 16),
                                               queued=True))
        q, k, v = qkv.reshape(8, 256, 3, 16, 64).unbind(2)
        s, c = sin[None, :, None, :], cos[None, :, None, :]
        q = rope_apply(q.to(torch.bfloat16), s, c).float().transpose(1, 2).contiguous()
        k = rope_apply(k.to(torch.bfloat16), s, c).float().transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()
        sdpa = cs._time_ms(lambda: F.scaled_dot_product_attention(q, k, v), queued=True)
        for name, t in times.items():
            print(f"time {name:13s} device ms {t[0]:.4f} / {t[1]:.4f} on {card}", flush=True)
        print(f"time exact SDPA (TF32 off) device ms {sdpa:.4f} on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
