"""vtp_tpu_torch: the PyTorch and CUDA port of ``vtp_tpu`` for NVIDIA Hopper.

Imports torch, numpy and the standard library only. This slice carries
the VTP reconstruction roundtrip (bf16 encode, exact fp32 decode) on a
hand-written CUDA fused qkv + RoPE attention kernel
(``csrc/fused_attention.cu``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where every kernel's plain PyTorch
version runs instead.
"""

from vtp_tpu_torch.config import PRESETS, VTPConfig, vtp_base, vtp_large, vtp_small
from vtp_tpu_torch.models.vtp_model import VTPModel

__all__ = ["PRESETS", "VTPConfig", "VTPModel", "vtp_base", "vtp_large", "vtp_small"]
