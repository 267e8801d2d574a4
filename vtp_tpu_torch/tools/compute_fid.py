"""FID between two image sources: folders of images or ADM-format .npz
(port of ``tools/compute_fid.py``). Activations reduce to streaming
moments; needs Inception weights (``$VTP_INCEPTION_WEIGHTS``).

    python -m vtp_tpu_torch.tools.compute_fid --path1 ./rec_out/ref --path2 ./rec_out/rec
    python -m vtp_tpu_torch.tools.compute_fid --path1 VIRTUAL_imagenet256_labeled.npz \\
        --path2 ./dit_samples [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Iterator, List, Optional

import numpy as np


def iter_batches(path: str, batch_size: int, image_size: int,
                 num_workers: int = 8) -> Iterator[np.ndarray]:
    """(B, 3, H, W) float32 batches in [0, 1]: an .npz's first array
    ((N, H, W, 3) uint8), or a folder's images resized to ``image_size``
    (BILINEAR) where they differ."""
    if path.endswith(".npz"):
        data = np.load(path)
        arr = data[data.files[0]]
        for s in range(0, len(arr), batch_size):
            yield (arr[s: s + batch_size].astype(np.float32) / 255.0).transpose(0, 3, 1, 2)
        return

    from vtp_tpu_torch.data import DataLoader, ImageFolder

    def transform(img):
        if img.size != (image_size, image_size):
            from PIL import Image

            img = img.resize((image_size, image_size), Image.BILINEAR)
        return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0

    for x, _ in DataLoader(ImageFolder(path, transform=transform), batch_size,
                           num_workers=num_workers):
        yield x


def main(argv: Optional[List[str]] = None) -> float:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--path1", required=True)
    p.add_argument("--path2", required=True)
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--image_size", type=int, default=299)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from vtp_tpu_torch.metrics import FrechetStats, fid_from_stats
    from vtp_tpu_torch.metrics.inception import load_inception_feature_fn

    feature_fn = load_inception_feature_fn(device=args.device)
    stats = []
    for path in (args.path1, args.path2):
        st, n = FrechetStats(2048), 0
        for batch in iter_batches(path, args.batch_size, args.image_size):
            st.update(feature_fn(torch.from_numpy(batch)))
            n += batch.shape[0]
            if n % 1000 < args.batch_size:
                print(f"{path}: {n} images", flush=True)
        print(f"{path}: {n} images total")
        stats.append(st)
    fid = fid_from_stats(stats[0], stats[1])
    print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
