"""VTP as the VAE of a latent diffusion model (port of
``vtp_tpu/generation/vtp_tokenizer.py``: ``VTPTokenizer`` :36).

The tokenizer with the interface LightningDiT expects: ``img_transform``
(ADM centre crop, optional flip, normalise), ``encode_images`` -> (B, d,
H/p, W/p) fp32 latents (a bf16 encode), ``decode_to_images`` -> uint8 HWC
images (an exact-fp32 decode), and the ``patch_size``, ``embed_dim``,
``downsample_ratio`` and ``latent_size`` attributes. It wraps the port's
``VTPModel``; latents and images stay on the model's device as tensors.

``from_checkpoint`` loads the model through ``VTPModel.from_checkpoint``.
``quantize_int8`` encodes with an int8 W8A8 trunk
(``VTPModel.quantize_for_serving``, the trunk only) for bulk extraction;
the decode stays the exact fp32 one. ``data_sharding`` (a DeviceMesh, the
JAX package's batch ``NamedSharding``): every rank passes the same global
batch, encodes or decodes its rows and all-gathers the result
(``parallel.sharding.data_parallel_apply``), so callers see the global
batch as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vtp_tpu_torch.models.vtp_model import VTPModel
from vtp_tpu_torch.parallel.mesh import check_mesh
from vtp_tpu_torch.parallel.sharding import data_parallel_apply

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NORMALIZE_HALF = {"mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5)}
NORMALIZE_IMAGENET = {"mean": IMAGENET_MEAN, "std": IMAGENET_STD}


def center_crop_arr(pil_image, image_size: int):
    """ADM centre crop (``vtp_tpu/utils/image.py:31``): halve with BOX while
    >= 2x the target, BICUBIC to scale, crop the centre."""
    from PIL import Image

    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(tuple(round(x * scale) for x in pil_image.size),
                                 resample=Image.BICUBIC)
    arr = np.array(pil_image)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return Image.fromarray(arr[cy:cy + image_size, cx:cx + image_size])


class VTPTokenizer:
    """The tokenizer over a ``VTPModel`` with a pixel decoder."""

    def __init__(self, model: VTPModel, img_size: int = 256, normalize_type: str = "imagenet",
                 data_sharding=None, quantize_int8: bool = False):
        if data_sharding is not None:
            check_mesh(data_sharding, "data_sharding")
        self.data_sharding = data_sharding
        if quantize_int8:
            model = model.quantize_for_serving(("trunk",))
        if normalize_type == "half":
            norm = NORMALIZE_HALF
        elif normalize_type == "imagenet":
            norm = NORMALIZE_IMAGENET
        else:
            raise ValueError(f"Unknown normalize_type: {normalize_type}")
        self.model = model
        self.config = config = model.config
        self.img_size = img_size
        self.normalize_type = normalize_type
        device = next(model.parameters()).device
        self.norm_mean = torch.tensor(norm["mean"], dtype=torch.float32, device=device).reshape(3, 1, 1)
        self.norm_std = torch.tensor(norm["std"], dtype=torch.float32, device=device).reshape(3, 1, 1)
        self.patch_size = config.vision_patch_size
        self.embed_dim = config.vision_feature_bottleneck
        self.downsample_ratio = self.patch_size
        self.latent_size = img_size // self.downsample_ratio

    @classmethod
    def from_checkpoint(cls, hf_model_path: str, device="cuda", **kw) -> "VTPTokenizer":
        """The tokenizer over ``VTPModel.from_checkpoint(hf_model_path,
        device)`` (an HF-layout or native checkpoint directory); ``kw`` goes
        to the constructor."""
        return cls(VTPModel.from_checkpoint(hf_model_path, device=device), **kw)

    def img_transform(self, p_hflip: float = 0.0, img_size: Optional[int] = None,
                      seed: int = 0) -> Callable[..., np.ndarray]:
        """PIL -> normalised (3, S, S) fp32 numpy. p_hflip in {0, 1} gives the
        deterministic pair; fractional values flip by a seeded RNG."""
        size = img_size or self.img_size
        rng = np.random.default_rng(seed)
        mean = self.norm_mean.cpu().numpy()
        std = self.norm_std.cpu().numpy()

        def transform(img) -> np.ndarray:
            from PIL import Image

            img = center_crop_arr(img, size)
            if p_hflip >= 1.0 or (p_hflip > 0.0 and rng.random() < p_hflip):
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            arr = np.asarray(img.convert("RGB"), np.float32).transpose(2, 0, 1) / 255.0
            return (arr - mean) / std

        return transform

    def _device_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.norm_mean.device)

    def _apply(self, fn, x: torch.Tensor) -> torch.Tensor:
        if self.data_sharding is None:
            return fn(x)
        return data_parallel_apply(fn, x, self.data_sharding)

    @torch.no_grad()
    def encode_images(self, images) -> torch.Tensor:
        """(B, 3, H, W) normalised -> (B, d, H/p, W/p) fp32 latents."""
        return self._apply(self.model.get_reconstruction_latents,
                           self._device_tensor(images)).float()

    @torch.no_grad()
    def decode_to_images(self, z) -> torch.Tensor:
        """(B, d, h, w) latents -> (B, H, W, 3) uint8 images."""
        decoded = self._apply(self.model.get_latents_decoded_images, self._device_tensor(z))
        decoded = decoded * self.norm_std[None] + self.norm_mean[None]
        images = torch.clamp(decoded * 255.0, 0, 255)
        return images.permute(0, 2, 3, 1).to(torch.uint8)


# the reference's name (generation/tokenizer/vtp_tokenizer.py:14)
VTP_Tokenizer = VTPTokenizer
