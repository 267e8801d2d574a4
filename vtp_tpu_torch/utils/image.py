"""Image preprocessing (port of ``vtp_tpu/utils/image.py``).

The eval protocols' host-side PIL operations, as the reference defines
them: the ADM centre crop (BOX halving, then BICUBIC, image_utils.py:5-32)
for reconstruction and the naive (s, s) BILINEAR resize for zero-shot.
rFID is defined on PIL resampling, so these stay on the host. PIL is
imported only inside the functions that decode or resize an image: the
module imports without it. ``normalize_nchw`` and ``denormalize_nchw``
take numpy arrays or torch tensors (on any device) and return the same
kind.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

# constants from the reference (models/utils/text_utils.py:12-17)
OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)


def center_crop_arr(pil_image, image_size: int):
    """ADM centre crop (vtp/utils/image_utils.py:5-32): halve with BOX
    while >= 2x target, BICUBIC to scale, crop the centre."""
    from PIL import Image

    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(tuple(round(x * scale) for x in pil_image.size),
                                 resample=Image.BICUBIC)
    arr = np.array(pil_image)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return Image.fromarray(arr[cy: cy + image_size, cx: cx + image_size])


def resize_naive(pil_image, size: int):
    """torchvision ``Resize((s, s))`` equivalent (BILINEAR), used by the
    zero-shot eval (test_zero_shot_hf.py:455-459)."""
    from PIL import Image

    return pil_image.resize((size, size), resample=Image.BILINEAR)


def to_nchw_float(pil_image) -> np.ndarray:
    """PIL -> (3, H, W) float32 in [0, 1] (torchvision ToTensor)."""
    arr = np.asarray(pil_image.convert("RGB"), np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def _stats(x, mean: Iterable[float], std: Iterable[float]):
    shape = (1, 3, 1, 1) if x.ndim == 4 else (3, 1, 1)
    if isinstance(x, torch.Tensor):
        make = lambda v: torch.tensor(tuple(v), dtype=torch.float32, device=x.device).reshape(shape)
    else:
        make = lambda v: np.asarray(tuple(v), np.float32).reshape(shape)
    return make(mean), make(std)


def normalize_nchw(x, mean: Iterable[float] = IMAGENET_MEAN, std: Iterable[float] = IMAGENET_STD):
    """(x - mean) / std over the channel axis of a (3, H, W) or (B, 3, H, W)
    numpy array or torch tensor."""
    m, s = _stats(x, mean, std)
    return (x - m) / s


def denormalize_nchw(x, mean: Iterable[float] = IMAGENET_MEAN,
                     std: Iterable[float] = IMAGENET_STD):
    """x * std + mean, the inverse of ``normalize_nchw``."""
    m, s = _stats(x, mean, std)
    return x * s + m


def load_image_for_reconstruction(path: str, image_size: int = 256) -> np.ndarray:
    """README-quickstart preprocessing: ADM crop + ImageNet normalise ->
    (1, 3, s, s) float32."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = center_crop_arr(img, image_size)
    return normalize_nchw(to_nchw_float(img)[None])
