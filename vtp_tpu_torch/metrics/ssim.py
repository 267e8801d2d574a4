"""SSIM with torchmetrics' defaults (port of ``vtp_tpu/metrics/ssim.py``;
the reference uses ``StructuralSimilarityIndexMeasure(data_range=1.0)``,
tools/test_reconstruction_hf.py:82-91): an 11x11 Gaussian window of sigma
1.5, K1 = 0.01, K2 = 0.03, valid (unpadded) windows, the mean over batch,
channels and positions. The depthwise filter is one ``conv2d`` in exact
fp32 (TF32 off on the card)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vtp_tpu_torch.models.pixel_decoder import exact_fp32


def gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(size, size) float32 window, the outer product of a normalised 1-D
    Gaussian computed in float64."""
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, *, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         per_image: bool = False) -> torch.Tensor:
    """SSIM over (B, C, H, W) images: the scalar batch mean (as torchmetrics
    takes it per batch), or per-image means with ``per_image=True``."""
    x, y = img1.float(), img2.float()
    c = x.shape[1]
    window = torch.from_numpy(gaussian_kernel(kernel_size, sigma)).to(x.device)
    window = window.expand(c, 1, kernel_size, kernel_size)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    with exact_fp32():
        mu_x, mu_y, mu_xx, mu_yy, mu_xy = (
            F.conv2d(t, window, groups=c) for t in (x, y, x * x, y * y, x * y))
    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    ssim_map = num / den
    return ssim_map.mean((1, 2, 3)) if per_image else ssim_map.mean()
