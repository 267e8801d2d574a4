"""ImageNet reconstruction eval CLI: PSNR, SSIM, LPIPS and rFID (port of
``tools/eval_reconstruction.py``; the reference's
``tools/test_reconstruction_hf.py`` protocol: ADM centre crop + ImageNet
normalisation, bf16 encode, exact fp32 decode, per-batch metrics, ref/rec
PNG dumps, rFID from streaming Inception moments or, when the folders are
already complete, from the saved PNGs). LPIPS and Inception weights come
from ``$VTP_LPIPS_WEIGHTS`` and ``$VTP_INCEPTION_WEIGHTS``; without them
that metric is skipped with a warning.

    python -m vtp_tpu_torch.tools.eval_reconstruction --model_path /path/to/vtp-l-hf \\
        --imagenet_val /path/to/imagenet/val --save_dir ./rec_out [--max_samples 50000] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional


def _write(results: Dict, output: Optional[str]) -> None:
    print(json.dumps(results, indent=2))
    if output:
        with open(output, "w") as f:
            json.dump(results, f, indent=2)


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", required=True)
    p.add_argument("--imagenet_val", required=True)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                   help="the encode's dtype; the decode is exact fp32")
    p.add_argument("--save_dir", default=None, help="dump ref/rec PNGs here")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.data import DataLoader, ImageFolder
    from vtp_tpu_torch.eval.reconstruction import (
        count_images,
        evaluate_reconstruction,
        fid_from_folders,
    )
    from vtp_tpu_torch.metrics.inception import load_inception_feature_fn
    from vtp_tpu_torch.metrics.lpips import LPIPS
    from vtp_tpu_torch.utils.image import center_crop_arr, normalize_nchw, to_nchw_float

    model = VTPModel.from_checkpoint(
        args.model_path, device=args.device,
        encode_dtype=torch.bfloat16 if args.precision == "bf16" else None)

    def transform(img):
        return normalize_nchw(to_nchw_float(center_crop_arr(img, args.image_size)))

    dataset = ImageFolder(args.imagenet_val, transform=transform)
    expected = min(len(dataset), args.max_samples or len(dataset))
    loader = DataLoader(dataset, args.batch_size, sampler=range(expected),
                        num_workers=args.num_workers)

    lpips_metric = LPIPS(device=args.device)
    if not lpips_metric.available:
        print("Warning: LPIPS weights not found (set VTP_LPIPS_WEIGHTS); LPIPS will not be "
              "calculated")
    try:
        inception_fn = load_inception_feature_fn(device=args.device)
    except FileNotFoundError as e:  # weights absent: the reference's degradation
        inception_fn = None
        print(f"Warning: Inception weights unavailable ({e}); rFID will not be calculated")

    # resume by skipping (test_reconstruction_hf.py:293-325): complete output
    # folders are not regenerated, and rFID comes from the saved PNGs
    if args.save_dir:
        ref_dir = os.path.join(args.save_dir, "ref")
        rec_dir = os.path.join(args.save_dir, "rec")
        if count_images(ref_dir) >= expected and count_images(rec_dir) >= expected:
            print(f"outputs already complete ({expected} images); skipping regeneration, "
                  "computing rFID from folders")
            results = {"num_samples": expected, "rfid": None}
            if inception_fn is not None:
                results["rfid"] = fid_from_folders(ref_dir, rec_dir, inception_fn)
            _write(results, args.output)
            return results

    results = evaluate_reconstruction(model, loader, save_dir=args.save_dir,
                                      max_samples=args.max_samples, lpips_metric=lpips_metric,
                                      inception_feature_fn=inception_fn, progress=False)
    _write(results, args.output)
    return results


if __name__ == "__main__":
    main()
