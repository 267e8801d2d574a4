"""VTP as the VAE of latent diffusion (port of ``vtp_tpu/generation``). The
latent-shard IO and statistics (``latents.py``) are not ported."""

from vtp_tpu_torch.generation.vtp_tokenizer import VTP_Tokenizer, VTPTokenizer

__all__ = ["VTPTokenizer", "VTP_Tokenizer"]
