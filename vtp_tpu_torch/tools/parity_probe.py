"""Kernel-against-plain parity probe (port of ``tools/parity_probe.py``,
without its TPU-grant handling).

Runs the same random weights and inputs through the hand-written kernels
and through their plain PyTorch versions (``ops.dispatch.plain_kernels()``)
and reports forward, loss and gradient-norm deltas per preset:

  * bf16 encode latents (the fused qkv + RoPE + attention forward);
  * CLIP image and text features (the bf16 arm, causal in the text tower);
  * the fp32 decode on a fixed latent input (the fp32 arm at the model's
    decode precision);
  * one CLIP + rec + SSL train step (remat on): each objective's loss and
    the global grad norm (the attention backward and the fused CE).

The gates and the JSON layout are the JAX tool's (its ``probe_preset``):
the decode within 1.5e-2 rel, the bf16 forwards within 5e-2, each loss
within 5e-3, the grad norm within 2e-2; any failure prints ``PARITY PROBE
FAILED: ...`` and exits 1. The plain arm must launch no kernel (checked
through ``launch_counts``). ``--presets`` runs each preset in a fresh
process with a timeout, vtp-large at ``min(batch, 4)``.

    python -m vtp_tpu_torch.tools.parity_probe --presets vtp-small,vtp-base,vtp-large \\
        --json parity_probe.json
    python -m vtp_tpu_torch.tools.parity_probe --device cpu --small

On ``--device cpu`` both arms run the plain versions (a CPU tensor never
reaches a kernel): a self-test of the plumbing, whose deltas are 0.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

from vtp_tpu_torch.config import PRESETS

# the JAX probe's TrainConfig overrides
TRAIN_KW = dict(train_ssl=True, warmup_steps=0, total_steps=100, remat=True)
_ROW_MARK = "PROBE_ROW:"
DELTAS = ("latents", "clip_image", "clip_text", "decode")


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    denom = max(float(np.abs(b).max()), 1e-12)
    return float(np.abs(a - b).max()) / denom


def run_arm(plain: bool, *, preset: str, batch: int, device: str = "cuda") -> dict:
    """Every probe of ``preset`` on the kernels, or inside ``plain_kernels()``
    (``plain``), from fixed seeds; the plain arm asserts it launched
    nothing. Returns the outputs as numpy, the losses, the grad norm, the
    launch counts and the wall time."""
    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.ops.dispatch import launch_counts, plain_kernels, reset_launch_counts
    from vtp_tpu_torch.train.step import TrainConfig, build_train_step, init_state, make_ssl_batch

    cfg = PRESETS[preset]()
    out: dict = {}
    t0 = time.perf_counter()
    reset_launch_counts()
    with plain_kernels() if plain else contextlib.nullcontext():
        model = VTPModel.init(cfg, torch.Generator(device=device).manual_seed(0), device=device)
        gen = torch.Generator(device=device).manual_seed(1)
        img = torch.randn((batch, 3, cfg.image_size, cfg.image_size), generator=gen,
                          device=device)
        txt = torch.randint(1, cfg.text_vocab_size - 1, (batch, cfg.text_context_length),
                            generator=gen, device=device)
        np32 = lambda t: t.detach().float().cpu().numpy()
        with torch.no_grad():
            out["latents"] = np32(model.get_reconstruction_latents(img))
            out["clip_image"] = np32(model.get_clip_image_feature(img))
            out["clip_text"] = np32(model.get_clip_text_feature(txt))
            # a fixed latent input, not this arm's bf16 latents, whose rounding
            # would alias into the decode delta
            g = cfg.image_size // cfg.vision_patch_size
            z = torch.randn((batch, cfg.vision_feature_bottleneck, g, g),
                            generator=torch.Generator(device=device).manual_seed(7),
                            device=device)
            out["decode"] = np32(model.get_latents_decoded_images(z))
        del model
        if device == "cuda":
            torch.cuda.empty_cache()
        tcfg = TrainConfig(**TRAIN_KW)
        state = init_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
        ssl = make_ssl_batch(torch.Generator(device=device).manual_seed(4), batch,
                             global_size=cfg.image_size, patch=cfg.vision_patch_size)
        step = build_train_step(cfg, tcfg)
        _, metrics = step(state, {"image": img, "text": txt, "rec_image": img, "ssl": ssl},
                          torch.Generator(device=device).manual_seed(2))
        out["losses"] = {k: float(v) for k, v in metrics.items() if k.startswith("loss/")}
        out["grad_norm"] = float(metrics["grad_norm"])
        del state
    out["launches"] = launch_counts()
    if plain and out["launches"]:
        raise AssertionError(f"the plain arm launched kernels: {out['launches']}")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    return out


def compare(preset: str, batch: int, backend: str, kern: dict, ref: dict) -> dict:
    """The JAX tool's report of two arms, key for key, with its gates."""
    report = {"preset": preset, "batch": batch, "backend": backend, "deltas": {}}
    for name in DELTAS:
        report["deltas"][name] = {"max_abs": float(np.abs(kern[name] - ref[name]).max()),
                                  "max_rel": _rel(kern[name], ref[name])}
    report["losses_kernel"] = kern["losses"]
    report["losses_fallback"] = ref["losses"]
    report["loss_rel"] = {k: abs(kern["losses"][k] - ref["losses"][k])
                          / max(abs(ref["losses"][k]), 1e-12) for k in kern["losses"]}
    report["grad_norm_kernel"] = kern["grad_norm"]
    report["grad_norm_fallback"] = ref["grad_norm"]
    report["grad_norm_rel"] = (abs(kern["grad_norm"] - ref["grad_norm"])
                               / max(abs(ref["grad_norm"]), 1e-12))
    fails = []
    if not report["deltas"]["decode"]["max_rel"] <= 1.5e-2:
        fails.append("decode rel > 1.5e-2")
    for name in ("latents", "clip_image", "clip_text"):
        if not report["deltas"][name]["max_rel"] <= 5e-2:
            fails.append(f"{name} bf16 rel > 5e-2")
    for k, v in report["loss_rel"].items():
        if not v <= 5e-3:
            fails.append(f"{k} rel {v:.2e} > 5e-3")
    if not report["grad_norm_rel"] <= 2e-2:
        fails.append(f"grad_norm rel {report['grad_norm_rel']:.2e} > 2e-2")
    report["fails"] = [f"{preset}: {f}" for f in fails]
    return report


def probe_preset(preset: str, batch: int, device: str = "cuda") -> dict:
    print(f"== preset {preset} batch {batch} device {device}", flush=True)
    if device == "cpu":
        print("device cpu: both arms run the plain versions (a CPU tensor never reaches a "
              "kernel); this is a self-test of the probe's plumbing, not a kernel check",
              flush=True)
    kern = run_arm(False, preset=preset, batch=batch, device=device)
    print(f"kernel arm done in {kern['wall_s']}s, launches {kern['launches']}", flush=True)
    ref = run_arm(True, preset=preset, batch=batch, device=device)
    print(f"fallback arm (plain versions) done in {ref['wall_s']}s, no launch", flush=True)
    return compare(preset, batch, device, kern, ref)


def _probe_in_subprocess(preset: str, batch: int, device: str, timeout: float) -> dict:
    """One preset in a fresh process, its report read from its
    ``PROBE_ROW:`` line; a failed or timed-out process is a failed preset."""
    cmd = [sys.executable, "-u", "-m", "vtp_tpu_torch.tools.parity_probe", "--preset", preset,
           "--batch", str(batch), "--device", device, "--emit-row"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"preset": preset, "batch": batch,
                "fails": [f"{preset}: probe subprocess ran past {timeout:g} s"]}
    sys.stdout.write(proc.stdout)
    for line in proc.stdout.splitlines():
        if line.startswith(_ROW_MARK):
            return json.loads(line[len(_ROW_MARK):])
    tail = (proc.stderr.strip().splitlines() or ["no stderr"])[-1]
    return {"preset": preset, "batch": batch,
            "fails": [f"{preset}: probe subprocess rc={proc.returncode}: {tail[:200]}"]}


def finish(probes: List[dict], backend: str, json_path: Optional[str] = None) -> int:
    """Print (and write) the result; 1 with ``PARITY PROBE FAILED`` on any
    failed gate, else 0."""
    fails = [f for r in probes for f in r["fails"]]
    result = probes[0] if len(probes) == 1 else {"probes": probes, "fails": fails,
                                                  "backend": backend}
    print(json.dumps(result, indent=2), flush=True)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(result, f, indent=2)
    if fails:
        print("PARITY PROBE FAILED: " + "; ".join(fails), flush=True)
        return 1
    print("PARITY PROBE OK", flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", default=None, help="comma list, e.g. vtp-small,vtp-base")
    ap.add_argument("--preset", default="vtp-small",
                    help="single preset (ignored when --presets is set)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--small", action="store_true", help="the small self-test size (batch 2)")
    ap.add_argument("--json", default=None, help="write the result dict here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds each --presets subprocess may run")
    ap.add_argument("--emit-row", action="store_true",
                    help="(internal) print the single-preset report as a PROBE_ROW: line")
    args = ap.parse_args(argv)
    if args.small:
        args.batch = 2
    if args.presets:
        presets = [p.strip() for p in args.presets.split(",")]
        print(f"presets={presets} batch={args.batch} (one fresh process per preset)",
              flush=True)
        batch_for = lambda p: min(args.batch, 4) if p == "vtp-large" else args.batch
        probes = [_probe_in_subprocess(p, batch_for(p), args.device, args.timeout)
                  for p in presets]
    else:
        probes = [probe_preset(args.preset, args.batch, args.device)]
        if args.emit_row:
            print(_ROW_MARK + json.dumps(probes[0]), flush=True)
    return finish(probes, args.device, args.json)


if __name__ == "__main__":
    raise SystemExit(main())
