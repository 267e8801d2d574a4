"""vtp_tpu_torch: the PyTorch and CUDA port of ``vtp_tpu`` for NVIDIA Hopper.

Imports torch, numpy and the standard library only. It carries the VTP
reconstruction roundtrip (bf16 encode; exact fp32, bf16x3 "high" or bf16
decode), the CLIP towers and the feature API, HF-layout checkpoints
(``vtp_tpu_torch.convert``) and the JAX package's native format, canonical
or head-major (``vtp_tpu_torch.checkpoint``), the batched server
(``vtp_tpu_torch.serve``), the CLIP+SSL+rec train step
(``vtp_tpu_torch.train.step``) and the DiT generation path
(``vtp_tpu_torch.dit``, ``vtp_tpu_torch.generation``), the eval harnesses
(``vtp_tpu_torch.eval``: reconstruction, zero-shot, linear probe) on hand-written CUDA
kernels (``csrc/``): the fused qkv + qk-norm + RoPE attention (bf16, exact
fp32 and bf16x3 arms), its backward with and without the qk-norm arm, the
fused DINO/iBOT cross-entropy, and the strided attention without a
prologue (the head-major trunk, ``ops/attention.sdpa``). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, where every
kernel's plain PyTorch version runs instead.
"""

from vtp_tpu_torch.config import PRESETS, VTPConfig, vtp_base, vtp_large, vtp_small
from vtp_tpu_torch.models.vtp_model import VTPModel

__all__ = ["PRESETS", "VTPConfig", "VTPModel", "vtp_base", "vtp_large", "vtp_small"]
