"""HF-layout VTP checkpoints (``config.json`` + ``*.safetensors``) for the
port, read and written without the ``safetensors`` package: port of
``vtp_tpu/convert/from_torch.py`` (``load_vtp_checkpoint``) and
``vtp_tpu/convert/to_torch.py`` (``save_hf_checkpoint``)."""

from vtp_tpu_torch.convert.from_torch import load_vtp_checkpoint
from vtp_tpu_torch.convert.safetensors_io import load_safetensors, save_safetensors
from vtp_tpu_torch.convert.to_torch import save_hf_checkpoint

__all__ = ["load_safetensors", "load_vtp_checkpoint", "save_hf_checkpoint", "save_safetensors"]
