"""Frechet distance with streaming statistics (port of
``vtp_tpu/metrics/fid.py``).

Activations reduce to running moments as they are produced (sum, X^T X,
count) and merge across workers, so the 50k x 2048 activation matrix is
never held; the mean, covariance and matrix square root run in float64 on
the host (scipy ``sqrtm``), the reference's numpy/scipy formula
(test_reconstruction_hf.py:168-176).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from vtp_tpu_torch.models.pixel_decoder import exact_fp32


@dataclasses.dataclass
class FrechetStats:
    """Streaming first and second moments of feature activations, float64."""

    dims: int
    total: np.ndarray = None  # (dims,)
    outer: np.ndarray = None  # (dims, dims)
    count: float = 0.0

    def __post_init__(self):
        if self.total is None:
            self.total = np.zeros((self.dims,), np.float64)
        if self.outer is None:
            self.outer = np.zeros((self.dims, self.dims), np.float64)

    def update(self, activations) -> None:
        """activations: (N, dims), a tensor on any device or an array."""
        if isinstance(activations, torch.Tensor):
            activations = activations.detach().cpu().numpy()
        a = np.asarray(activations, np.float64)
        self.total += a.sum(axis=0)
        self.outer += a.T @ a
        self.count += a.shape[0]

    def merge(self, other: "FrechetStats") -> "FrechetStats":
        out = FrechetStats(self.dims)
        out.total = self.total + other.total
        out.outer = self.outer + other.outer
        out.count = self.count + other.count
        return out

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, sigma), sigma the sample covariance (ddof = 1) of
        ``np.cov(act, rowvar=False)``."""
        mu = self.total / self.count
        sigma = (self.outer - self.count * np.outer(mu, mu)) / (self.count - 1)
        return mu, sigma


def activation_moments(activations: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One batch's partial moments on its own device, in fp32 (TF32 off):
    (sum, X^T X, count), to be summed across batches or workers."""
    a = activations.float()
    with exact_fp32():
        return a.sum(0), a.t() @ a, a.shape[0]


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)), the square root by
    scipy ``sqrtm`` in float64; an offset of eps on the diagonals when the
    root is not finite, as the reference."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if isinstance(covmean, tuple):  # older scipy returns (sqrtm, errest)
        covmean = covmean[0]
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if isinstance(covmean, tuple):
            covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_stats(stats1: FrechetStats, stats2: FrechetStats) -> float:
    mu1, s1 = stats1.finalize()
    mu2, s2 = stats2.finalize()
    return frechet_distance(mu1, s1, mu2, s2)
