"""Multi-crop SSL augmentation for VTP pre-training (port of
``vtp_tpu/data/ssl_crops.py``, bit for bit: the same numpy draws in the
same order and the same PIL resamples).

Two global RandomResizedCrops and N local ones per image, each flipped
with p = 0.5 and normalised with the ImageNet statistics; the iBOT patch
masks in the static-``upperbound`` layout the train step consumes
(``train/step.py`` ``make_ssl_batch`` documents the layout). Host-side
numpy and PIL (PIL imported where an image is cropped), threaded by
``data.DataLoader``.
"""

from __future__ import annotations

import itertools
import math
from typing import TYPE_CHECKING, Dict, List, Sequence, Tuple

import numpy as np

from vtp_tpu_torch.data.imagefolder import ImageFolder
from vtp_tpu_torch.utils.image import IMAGENET_MEAN, IMAGENET_STD

if TYPE_CHECKING:
    from PIL import Image


def random_resized_crop(
    img: "Image.Image",
    size: int,
    rng: np.random.Generator,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> "Image.Image":
    """torchvision ``RandomResizedCrop`` semantics: 10 attempts at a
    log-uniform-aspect area-uniform box, center-crop fallback; BICUBIC
    resize to ``size``."""
    from PIL import Image

    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            return img.resize((size, size), Image.BICUBIC, box=(x, y, x + cw, y + ch))
    # fallback: largest center crop within the ratio bounds
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x, y = (w - cw) // 2, (h - ch) // 2
    return img.resize((size, size), Image.BICUBIC, box=(x, y, x + cw, y + ch))


def _to_normalized_chw(img: "Image.Image", mean, std) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return arr.transpose(2, 0, 1)


class MultiCropTransform:
    """PIL image -> (global_crops (2,3,G,G), local_crops (n,3,L,L)).

    Crop-scale splits follow DINOv2 (globals cover >=32% of the image,
    locals 5-32%); both are flipped independently with p=0.5.
    """

    def __init__(
        self,
        global_size: int = 256,
        local_size: int = 96,
        n_local: int = 4,
        global_scale: Tuple[float, float] = (0.32, 1.0),
        local_scale: Tuple[float, float] = (0.05, 0.32),
        mean: Sequence[float] = IMAGENET_MEAN,
        std: Sequence[float] = IMAGENET_STD,
    ):
        self.global_size = global_size
        self.local_size = local_size
        self.n_local = n_local
        self.global_scale = global_scale
        self.local_scale = local_scale
        self.mean = tuple(mean)
        self.std = tuple(std)

    def _one(self, img, size, scale, rng) -> np.ndarray:
        from PIL import Image

        crop = random_resized_crop(img, size, rng, scale=scale)
        if rng.uniform() < 0.5:
            crop = crop.transpose(Image.FLIP_LEFT_RIGHT)
        return _to_normalized_chw(crop, self.mean, self.std)

    def __call__(self, img: "Image.Image", rng: np.random.Generator):
        img = img.convert("RGB")
        g = np.stack(
            [self._one(img, self.global_size, self.global_scale, rng) for _ in range(2)]
        )
        l = (
            np.stack(
                [self._one(img, self.local_size, self.local_scale, rng)
                 for _ in range(self.n_local)]
            )
            if self.n_local
            else np.zeros((0, 3, self.local_size, self.local_size), np.float32)
        )
        return g, l


class MultiCropDataset:
    """ImageFolder + MultiCropTransform; items are
    ``(global_crops, local_crops, label)``. Deterministic per (seed,
    epoch, index) so multi-host shards don't correlate crops."""

    def __init__(self, folder: ImageFolder, transform: MultiCropTransform,
                 seed: int = 0):
        self.folder = folder
        self.transform = transform
        self.seed = seed
        self.epoch = 0
        # visits-based epoch estimate so crops differ across passes even
        # when the caller never calls set_epoch (itertools.count is
        # atomic under the GIL, safe for the threaded DataLoader)
        self._visits = itertools.count()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.folder)

    def __getitem__(self, idx: int):
        path, label = self.folder.samples[idx]
        img = self.folder.loader(path)
        epoch = self.epoch + next(self._visits) // max(len(self.folder), 1)
        rng = np.random.default_rng((self.seed, epoch, idx))
        g, l = self.transform(img, rng)
        return g, l, label


def collate_multicrop(items: List[Tuple[np.ndarray, np.ndarray, int]]):
    """Batch layout matching the train step (``train/step.py`` ``ssl_branch``):
    global crops are ``[crop0 of all imgs | crop1 of all imgs]`` so the
    teacher's crop swap is a concat-roll; locals likewise grouped by
    crop index."""
    g = np.stack([it[0] for it in items])  # (B, 2, 3, G, G)
    l = np.stack([it[1] for it in items])  # (B, n, 3, L, L)
    labels = np.asarray([it[2] for it in items], np.int64)
    B = g.shape[0]
    global_crops = g.transpose(1, 0, 2, 3, 4).reshape(-1, *g.shape[2:])
    local_crops = (
        l.transpose(1, 0, 2, 3, 4).reshape(-1, *l.shape[2:])
        if l.shape[1]
        else l.reshape(0, *l.shape[2:])
    )
    return global_crops, local_crops, labels


def make_mask_bookkeeping(
    rng: np.random.Generator,
    n_imgs: int,
    n_patches: int,
    mask_ratio: float = 0.3,
    upperbound_ratio: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Random iBOT patch masks in the static-``upperbound`` layout the
    step consumes (reference vtp.py:365-383; see
    ``train/step.py:make_ssl_batch`` for the synthetic twin):

      masks        (n_imgs, n_patches) bool — token replaced by mask_token
      mask_indices (upperbound,) int32 — flat indices of masked tokens,
                   zero-padded past ``n_masked``
      mask_weight  (upperbound,) float32 — 1 for live rows, 0 for pad
    """
    n_tokens = n_imgs * n_patches
    upperbound = int(n_tokens * upperbound_ratio)
    n_masked = min(int(n_tokens * mask_ratio), upperbound)
    perm = rng.permutation(n_tokens)
    mask_indices = np.zeros((upperbound,), np.int32)
    mask_indices[:n_masked] = perm[:n_masked]
    mask_weight = (np.arange(upperbound) < n_masked).astype(np.float32)
    masks = np.zeros((n_tokens,), bool)
    masks[perm[:n_masked]] = True
    return {
        "masks": masks.reshape(n_imgs, n_patches),
        "mask_indices": mask_indices,
        "mask_weight": mask_weight,
    }
