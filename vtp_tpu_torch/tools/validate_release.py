"""Release validation (port of ``tools/validate_release.py``): run the port's
three eval CLIs (rFID, zero-shot, linear probing) on a checkpoint, each as a
``python -m vtp_tpu_torch.tools.<name>`` subprocess, and hold the results
against the published numbers within their tolerances (rFID +-0.02, top-1
+-0.1 pt). Writes ``validate_release.json`` into ``--work_dir`` and exits 1
when any check fails.

    python -m vtp_tpu_torch.tools.validate_release --model_path /ckpts/VTP-Large-f16d64 \\
        --imagenet_root /data/imagenet [--skip linear_probe] [--max_samples 50000] \\
        [--device cpu]

Published numbers: reference README.md:140-168; protocols:
tools/test_reconstruction_hf.py:366-370 (bf16 encode, fp32 decode),
test_zero_shot_hf.py:455-459 (naive 256 resize), test_linear_probing_hf.py:
56-64 (224 crops, the 13-rate sweep). ``--probe_epochs`` and
``--probe_epoch_length`` cut the probe's schedule for a quick run (the
tolerances hold only for the full protocol).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

# The directory that holds the vtp_tpu_torch package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# reference README.md:164-166
PUBLISHED = {
    "vtp-small": {"rfid": 0.98, "zero_shot_top1": 66.7, "linear_probe_top1": 77.5},
    "vtp-base": {"rfid": 0.74, "zero_shot_top1": 73.2, "linear_probe_top1": 81.0},
    "vtp-large": {"rfid": 0.36, "zero_shot_top1": 78.2, "linear_probe_top1": 85.7},
}
EMBED_TO_SIZE = {384: "vtp-small", 768: "vtp-base", 1024: "vtp-large"}

TOLERANCES = {"rfid": 0.02, "zero_shot_top1": 0.1, "linear_probe_top1": 0.1}


def detect_size(model_path: str) -> str:
    with open(os.path.join(model_path, "config.json")) as f:
        cfg = json.load(f)
    dim = cfg.get("vision_embed_dim", cfg.get("vision_width"))
    if dim not in EMBED_TO_SIZE:
        raise SystemExit(f"unknown model size (vision_embed_dim={dim}); "
                         f"pass --expected explicitly")
    return EMBED_TO_SIZE[dim]


def run_tool(name: str, args: List[str], out_path: Optional[str] = None) -> dict:
    cmd = [sys.executable, "-m", f"vtp_tpu_torch.tools.{name}", *args]
    if out_path is not None:
        cmd += ["--output", out_path]
    print(f"[validate] $ {' '.join(cmd)}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    subprocess.run(cmd, check=True, env=env)
    if out_path is not None:
        with open(out_path) as f:
            return json.load(f)
    return {}


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", required=True, help="checkpoint directory")
    p.add_argument("--imagenet_root", required=True, help="ImageNet dir with train/ and val/")
    p.add_argument("--work_dir", default="./validate_release_out")
    p.add_argument("--max_samples", type=int, default=None,
                   help="subsample the validation set for a quick run (the tolerances "
                        "hold only at the full 50k)")
    p.add_argument("--skip", nargs="*", default=[],
                   choices=["reconstruction", "zero_shot", "linear_probe"])
    p.add_argument("--expected", default=None,
                   help="override the model size (vtp-small|vtp-base|vtp-large)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--probe_epochs", type=int, default=None)
    p.add_argument("--probe_epoch_length", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    size = args.expected or detect_size(args.model_path)
    expected = PUBLISHED[size]
    os.makedirs(args.work_dir, exist_ok=True)
    val = os.path.join(args.imagenet_root, "val")

    results, failures = {"model": size}, []

    def check(metric: str, got: float) -> None:
        want, tol = expected[metric], TOLERANCES[metric]
        ok = abs(got - want) <= tol
        results[metric] = {"got": got, "published": want, "tol": tol, "ok": ok}
        print(f"[validate] {metric}: got {got:.4g} vs published {want} "
              f"(+-{tol}) -> {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(metric)

    common = ["--model_path", args.model_path, "--batch_size", str(args.batch_size),
              "--device", args.device]
    if args.max_samples:
        common += ["--max_samples", str(args.max_samples)]

    if "reconstruction" not in args.skip:
        r = run_tool("eval_reconstruction", [
            *common, "--imagenet_val", val, "--save_dir", os.path.join(args.work_dir, "rec"),
        ], os.path.join(args.work_dir, "reconstruction.json"))
        if r.get("rfid") is not None:
            check("rfid", float(r["rfid"]))
        else:
            print("[validate] rFID unavailable (Inception weights missing)", flush=True)
            failures.append("rfid-unavailable")
        results["reconstruction_raw"] = r

    if "zero_shot" not in args.skip:
        r = run_tool("eval_zero_shot", [*common, "--imagenet_val", val],
                     os.path.join(args.work_dir, "zero_shot.json"))
        check("zero_shot_top1", float(r["top1"]))
        results["zero_shot_raw"] = r

    if "linear_probe" not in args.skip:
        probe_dir = os.path.join(args.work_dir, "probe")
        schedule = []
        if args.probe_epochs is not None:
            schedule += ["--epochs", str(args.probe_epochs)]
        if args.probe_epoch_length is not None:
            schedule += ["--epoch_length", str(args.probe_epoch_length)]
        run_tool("eval_linear_probing", [
            *common, "--imagenet_root", args.imagenet_root, "--output_dir", probe_dir, *schedule,
        ])
        with open(os.path.join(probe_dir, "linear_probing_results.json")) as f:
            r = json.load(f)
        check("linear_probe_top1", float(r["best_accuracy"]))  # already in %
        results["linear_probe_raw"] = r

    results["passed"] = not failures
    out = os.path.join(args.work_dir, "validate_release.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"passed": results["passed"], "failures": failures, "details": out}))
    if failures:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
