"""Class-per-directory image dataset (port of ``vtp_tpu/data/imagefolder.py``;
torchvision ``ImageFolder`` semantics without torchvision).

Classes are the sorted subdirectory names (a flat directory of images is
one pseudo-class "."), samples are (path, class_index) in sorted order,
so metric sample order matches the reference's. Images are decoded with
PIL, imported when the first sample is read.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


def list_image_files(directory: str) -> List[str]:
    return sorted(f for f in os.listdir(directory) if f.lower().endswith(IMG_EXTENSIONS))


def _pil_rgb(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


class ImageFolder:
    """samples[i] = (path, class_index); classes sorted like torchvision."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 loader: Optional[Callable[[str], object]] = None):
        self.root = root
        self.transform = transform
        self.loader = loader or _pil_rgb
        self.classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            self.classes = ["."]  # flat directory of images -> single pseudo-class
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root, c) if c != "." else root
            for f in list_image_files(cdir):
                self.samples.append((os.path.join(cdir, f), self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, label
