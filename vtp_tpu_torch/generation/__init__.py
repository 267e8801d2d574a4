"""VTP as the VAE of latent diffusion (port of ``vtp_tpu/generation``): the
tokenizer and the latent-shard IO and statistics."""

from vtp_tpu_torch.generation.latents import (
    compute_latent_stats,
    load_latent_shards,
    save_latent_shard,
)
from vtp_tpu_torch.generation.vtp_tokenizer import VTP_Tokenizer, VTPTokenizer

__all__ = [
    "VTPTokenizer",
    "VTP_Tokenizer",
    "compute_latent_stats",
    "load_latent_shards",
    "save_latent_shard",
]
