"""Class-conditional sampling: DiT latents -> VTP decode -> images (port of
``vtp_tpu/dit/sample.py``: ``make_sampler`` :22, ``sample_images`` :46).

The euler ODE at 250 steps on the timestep grid shifted by 0.075, cfg 1.0
(off) for the headline no-cfg gFID, then the latents are de-normalised
with the per-channel latent statistics and decoded through the VTP pixel
decoder to uint8 images.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vtp_tpu_torch.dit.model import DiT, DiTConfig
from vtp_tpu_torch.dit.transport import euler_sample


def make_sampler(cfg: DiTConfig, *, num_steps: int = 250, timestep_shift: float = 0.075,
                 cfg_scale: float = 1.0, compute_dtype: Optional[torch.dtype] = torch.bfloat16):
    """Returns ``sample(model, labels, generator=None, noise=None) -> latents``,
    (B, C, H, W) fp32 on the labels' device; ``noise`` is the initial
    noise, drawn from ``generator`` when not given."""

    @torch.no_grad()
    def sample(model: DiT, labels: torch.Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        model_fn = lambda x, t, y: model(x, t, y, compute_dtype=compute_dtype)
        shape = (labels.shape[0], cfg.in_channels, cfg.input_size, cfg.input_size)
        return euler_sample(model_fn, shape, labels, generator=generator, x=noise,
                            num_steps=num_steps, timestep_shift=timestep_shift,
                            cfg_scale=cfg_scale, null_label=cfg.null_label)

    return sample


def sample_images(
    model: DiT,
    tokenizer,                       # vtp_tpu_torch.generation.VTPTokenizer
    labels: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    latent_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    num_steps: int = 250,
    timestep_shift: float = 0.075,
    cfg_scale: float = 1.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-> (B, H, W, 3) uint8 images on the labels' device. ``latent_stats``
    is the (mean, std) the latents were normalised with, each broadcastable
    to (B, C, H, W)."""
    sampler = make_sampler(model.config, num_steps=num_steps, timestep_shift=timestep_shift,
                           cfg_scale=cfg_scale)
    z = sampler(model, labels, generator, noise)
    if latent_stats is not None:
        mean, std = latent_stats
        z = z * std + mean
    return tokenizer.decode_to_images(z)
