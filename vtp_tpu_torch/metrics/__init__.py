"""Reconstruction metrics (port of ``vtp_tpu/metrics``): PSNR, SSIM,
streaming Frechet statistics and FID, the FID Inception-v3 and LPIPS.
Their convolutions are plain PyTorch (cuDNN on the card, TF32 off), as
the JAX package leaves them to XLA outside any Pallas kernel."""

from vtp_tpu_torch.metrics.fid import FrechetStats, fid_from_stats, frechet_distance
from vtp_tpu_torch.metrics.lpips import LPIPS, lpips_available
from vtp_tpu_torch.metrics.psnr import psnr
from vtp_tpu_torch.metrics.ssim import ssim

__all__ = ["FrechetStats", "LPIPS", "fid_from_stats", "frechet_distance", "lpips_available",
           "psnr", "ssim"]
