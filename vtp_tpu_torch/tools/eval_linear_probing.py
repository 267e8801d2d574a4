"""ImageNet linear probing CLI (port of ``tools/eval_linear_probing.py``; the
reference's ``tools/test_linear_probing_hf.py`` protocol: frozen last-4-layer
features, 26 heads (2 block counts x 13 rates, avgpool) trained jointly with
SGD and a cosine schedule for 10 x 1250 steps on RandomResizedCrop(224,
bicubic) + flip crops, evaluated on Resize(256, bicubic) + CenterCrop(224),
the best head reported). Writes ``linear_probing_results.json`` into
``--output_dir``.

    python -m vtp_tpu_torch.tools.eval_linear_probing --model_path /path/to/vtp-l-hf \\
        --imagenet_root /path/to/imagenet [--batch_size 128] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_path", required=True,
                   help="checkpoint directory (HF layout or the native format)")
    p.add_argument("--imagenet_root", required=True, help="dir with train/ and val/")
    p.add_argument("--output_dir", default="./linear_probing_results")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--epoch_length", type=int, default=1250)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--max_samples", type=int, default=None,
                   help="evaluate on the first N validation images only")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from vtp_tpu_torch import VTPModel
    from vtp_tpu_torch.data import DataLoader, ImageFolder, InfiniteSampler
    from vtp_tpu_torch.eval.linear_probe import (
        ProbeConfig,
        build_probe_train_step,
        evaluate_linear_probe,
        init_probe_heads,
        init_probe_state,
    )
    from vtp_tpu_torch.utils.image import normalize_nchw, to_nchw_float

    dtype = torch.bfloat16 if args.precision == "bf16" else None
    model = VTPModel.from_checkpoint(args.model_path, device=args.device, encode_dtype=dtype)
    rng = np.random.default_rng(0)
    crop = args.crop_size

    def train_transform(img):
        from PIL import Image

        # RandomResizedCrop(crop, bicubic) + flip
        w, h = img.size
        for _ in range(10):
            area = w * h * rng.uniform(0.08, 1.0)
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw, ch = int(round(np.sqrt(area * ar))), int(round(np.sqrt(area / ar)))
            if cw <= w and ch <= h:
                x0 = rng.integers(0, w - cw + 1)
                y0 = rng.integers(0, h - ch + 1)
                img2 = img.crop((x0, y0, x0 + cw, y0 + ch))
                break
        else:
            s = min(w, h)
            img2 = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
        img2 = img2.resize((crop, crop), Image.BICUBIC)
        if rng.random() < 0.5:
            img2 = img2.transpose(Image.FLIP_LEFT_RIGHT)
        return normalize_nchw(to_nchw_float(img2))

    def eval_transform(img):
        from PIL import Image

        # Resize(256, bicubic) + CenterCrop(crop)
        w, h = img.size
        s = 256 / min(w, h)
        img = img.resize((round(w * s), round(h * s)), Image.BICUBIC)
        w, h = img.size
        x0, y0 = (w - crop) // 2, (h - crop) // 2
        return normalize_nchw(to_nchw_float(img.crop((x0, y0, x0 + crop, y0 + crop))))

    train_ds = ImageFolder(os.path.join(args.imagenet_root, "train"), transform=train_transform)
    val_ds = ImageFolder(os.path.join(args.imagenet_root, "val"), transform=eval_transform)

    pcfg = ProbeConfig(epochs=args.epochs, epoch_length=args.epoch_length,
                       batch_size=args.batch_size)
    gen = torch.Generator(device=args.device).manual_seed(0)
    state = init_probe_state(init_probe_heads(model.config, pcfg, args.batch_size, gen,
                                              device=args.device))
    step_fn = build_probe_train_step(model, pcfg, dtype)

    train_loader = DataLoader(train_ds, args.batch_size, sampler=InfiniteSampler(len(train_ds)),
                              num_workers=args.num_workers, drop_last=True)
    n_val = min(len(val_ds), args.max_samples or len(val_ds))
    val_loader = DataLoader(val_ds, args.batch_size, sampler=range(n_val),
                            num_workers=args.num_workers)

    os.makedirs(args.output_dir, exist_ok=True)
    best_acc, best_key, accs = 0.0, "", {}
    it = iter(train_loader)
    every = max(1, args.epoch_length // 10)
    for epoch in range(args.epochs):
        for i in range(args.epoch_length):
            images, labels = next(it)
            state, loss = step_fn(state, torch.as_tensor(images).to(args.device),
                                  torch.as_tensor(labels).to(args.device))
            if (i + 1) % every == 0:
                print(f"epoch {epoch} step {i + 1}/{args.epoch_length}: loss {float(loss):.4f}",
                      flush=True)
        accs = evaluate_linear_probe(model, state, val_loader, pcfg, dtype)
        key = max(accs, key=accs.get)
        if accs[key] > best_acc:
            best_acc, best_key = accs[key], key
        print(f"epoch {epoch}: best {accs[key]:.2f}% ({key})")

    results = {"best_accuracy": best_acc, "best_classifier": best_key, "all_accuracies": accs}
    with open(os.path.join(args.output_dir, "linear_probing_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"best_accuracy": best_acc, "best_classifier": best_key}, indent=2))
    return results


if __name__ == "__main__":
    main()
