"""ImageNet reconstruction evaluation: PSNR, SSIM, LPIPS and rFID (port of
``vtp_tpu/eval/reconstruction.py``; behavioural reference
``tools/test_reconstruction_hf.py:191-468``).

The loader yields ADM-cropped, ImageNet-normalised fp32 NCHW images; the
model encodes them in its ``encode_dtype`` (bf16 by default) and decodes
the latents in exact fp32; both sides are denormalised and clamped to
[0, 1]. Per batch: PSNR per image (on [0, 255]), SSIM as torchmetrics
takes it (the batch mean, averaged over batches as the reference does),
LPIPS per image when its weights are present, and Inception activations
reduced to streaming moments (``FrechetStats``) when a feature function is
given, so rFID needs no second pass over PNGs; ``save_dir`` also writes
the ref/rec PNG pairs (PIL), for the reference's folder protocol
(``fid_from_folders``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from vtp_tpu_torch.metrics.fid import FrechetStats, fid_from_stats
from vtp_tpu_torch.metrics.lpips import LPIPS
from vtp_tpu_torch.metrics.psnr import psnr
from vtp_tpu_torch.metrics.ssim import ssim
from vtp_tpu_torch.utils.image import denormalize_nchw

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")


def fid_from_folders(ref_dir: str, rec_dir: str, feature_fn: Callable,
                     batch_size: int = 50, num_workers: int = 8) -> float:
    """rFID over saved PNG folders (the reference's second pass,
    test_reconstruction_hf.py:434-438), from streaming moments."""
    from vtp_tpu_torch.data import DataLoader, ImageFolder

    def transform(img):
        return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0

    stats = []
    for d in (ref_dir, rec_dir):
        st = FrechetStats(2048)
        for x, _ in DataLoader(ImageFolder(d, transform=transform), batch_size,
                               num_workers=num_workers):
            st.update(feature_fn(torch.from_numpy(x)))
        stats.append(st)
    return fid_from_stats(stats[0], stats[1])


def count_images(directory: str) -> int:
    if not os.path.isdir(directory):
        return 0
    return sum(1 for f in os.listdir(directory) if f.lower().endswith(IMAGE_EXTENSIONS))


def make_roundtrip_fn(model) -> Callable[[torch.Tensor], tuple]:
    """normalised images -> (orig01, recon01), both clamped to [0, 1]: the
    encode in ``model.encode_dtype``, the decode in exact fp32."""

    @torch.no_grad()
    def roundtrip(images: torch.Tensor):
        latents = model.get_reconstruction_latents(images)
        recon = model.get_latents_decoded_images(latents, precision="float32")
        return (denormalize_nchw(images.float()).clamp(0.0, 1.0),
                denormalize_nchw(recon.float()).clamp(0.0, 1.0))

    return roundtrip


def _save_pngs(batch01: torch.Tensor, directory: str, prefix: str, start: int) -> None:
    from PIL import Image

    arr = (batch01.permute(0, 2, 3, 1).cpu().numpy() * 255.0).astype(np.uint8)
    for i in range(arr.shape[0]):
        Image.fromarray(arr[i]).save(os.path.join(directory, f"{prefix}_{start + i:06d}.png"))


def evaluate_reconstruction(
    model,
    dataloader,
    *,
    save_dir: Optional[str] = None,
    max_samples: Optional[int] = None,
    lpips_metric: Optional[LPIPS] = None,
    inception_feature_fn: Optional[Callable] = None,
    progress: bool = False,
) -> Dict[str, Optional[float]]:
    """Run the roundtrip eval over ``dataloader`` (batches of (images,
    labels); images numpy or tensors, moved to the model's device) on a
    ``VTPModel``. Returns {psnr, ssim, lpips, rfid, num_samples}; lpips and
    rfid are None without their weights. Stops after the batch that
    reaches ``max_samples``."""
    device = next(model.parameters()).device
    roundtrip = make_roundtrip_fn(model)
    lpips_metric = lpips_metric if lpips_metric is not None else LPIPS(device=device)

    ref_dir = rec_dir = None
    if save_dir:
        ref_dir, rec_dir = os.path.join(save_dir, "ref"), os.path.join(save_dir, "rec")
        os.makedirs(ref_dir, exist_ok=True)
        os.makedirs(rec_dir, exist_ok=True)
    stats = (FrechetStats(2048), FrechetStats(2048)) if inception_feature_fn else None

    psnr_sum = lpips_sum = ssim_batch_sum = 0.0
    n_img = n_batches = 0
    it = dataloader
    if progress:
        from tqdm import tqdm  # type: ignore

        it = tqdm(dataloader, desc="reconstruction eval")
    for images, _ in it:
        images = torch.as_tensor(images).to(device)
        orig01, recon01 = roundtrip(images)
        psnr_sum += psnr(orig01 * 255.0, recon01 * 255.0).sum().item()
        # the reference averages torchmetrics' batch SSIM over steps
        ssim_batch_sum += ssim(orig01, recon01).item()
        n_batches += 1
        if lpips_metric.available:
            lpips_sum += lpips_metric(orig01 * 2.0 - 1.0, recon01 * 2.0 - 1.0).sum().item()
        if stats is not None:
            stats[0].update(inception_feature_fn(orig01))
            stats[1].update(inception_feature_fn(recon01))
        if save_dir:
            _save_pngs(orig01, ref_dir, "ref", n_img)
            _save_pngs(recon01, rec_dir, "rec", n_img)
        n_img += images.shape[0]
        if max_samples is not None and n_img >= max_samples:
            break

    results: Dict[str, Optional[float]] = {
        "psnr": psnr_sum / n_img if n_img else None,
        "ssim": ssim_batch_sum / n_batches if n_batches else None,
        "lpips": lpips_sum / n_img if (n_img and lpips_metric.available) else None,
        "rfid": None,
        "num_samples": n_img,
    }
    if stats is not None and n_img > 1:
        results["rfid"] = fid_from_stats(*stats)
    return results
