"""ImageNet zero-shot eval CLI (port of ``tools/eval_zero_shot.py``; the
reference's ``tools/test_zero_shot_hf.py`` protocol: naive (S, S) resize +
ImageNet normalisation, the 1000-class x 80-template classifier, 100x
cosine logits, top-1 and top-5). The CLIP BPE merges file comes from
``$VTP_BPE_PATH``.

    python -m vtp_tpu_torch.tools.eval_zero_shot --model_path /path/to/vtp-l-hf \\
        --imagenet_val /path/to/imagenet/val [--batch_size 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple


def main(argv: Optional[List[str]] = None) -> Tuple[float, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", required=True,
                   help="checkpoint directory (HF layout or the native format)")
    p.add_argument("--imagenet_val", required=True)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--output", default=None, help="optional JSON results path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.data import DataLoader, ImageFolder
    from vtp_tpu_torch.eval.zero_shot import build_zero_shot_classifier, evaluate_zero_shot
    from vtp_tpu_torch.tokenizers import get_tokenizer
    from vtp_tpu_torch.utils.image import normalize_nchw, resize_naive, to_nchw_float

    dtype = torch.bfloat16 if args.precision == "bf16" else None
    model = VTPModel.from_checkpoint(args.model_path, device=args.device, encode_dtype=dtype)
    tokenizer = get_tokenizer(context_length=model.config.text_context_length)

    def transform(img):
        return normalize_nchw(to_nchw_float(resize_naive(img, args.image_size)))

    dataset = ImageFolder(args.imagenet_val, transform=transform)
    loader = DataLoader(dataset, args.batch_size,
                        sampler=range(min(len(dataset), args.max_samples or len(dataset))),
                        num_workers=args.num_workers)
    print("Building zero-shot classifier (1000 classes x 80 templates)...")
    classifier = build_zero_shot_classifier(model, tokenizer, compute_dtype=dtype)
    top1, top5 = evaluate_zero_shot(model, classifier, loader, compute_dtype=dtype)
    print(f"Top-1: {top1:.2f}%  Top-5: {top5:.2f}%")
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"top1": top1, "top5": top5}, f, indent=2)
    return top1, top5


if __name__ == "__main__":
    main()
