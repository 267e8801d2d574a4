"""Load a released HF-layout VTP checkpoint (port of
``vtp_tpu/convert/from_torch.py:264-285``, ``load_vtp_checkpoint``).

The port keeps the reference checkpoint's names and torch layouts, so no
layout conversion is needed: the state dict feeds
``VTPModel.load_numpy_state_dict`` as it is, which folds a
``LinearKMaskedBias.bias_mask`` into the qkv bias and casts the RoPE
periods to the rope dtype.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.convert.safetensors_io import load_safetensors


def load_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    """Every ``*.safetensors`` file of the directory (or the one file),
    merged in name order."""
    if os.path.isdir(path):
        files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith(".safetensors")]
    else:
        files = [path]
    sd: Dict[str, np.ndarray] = {}
    for f in files:
        sd.update(load_safetensors(f))
    return sd


def load_vtp_checkpoint(path: str, config: Optional[VTPConfig] = None
                        ) -> Tuple[VTPConfig, Dict[str, np.ndarray]]:
    """A checkpoint directory (``config.json`` + ``*.safetensors``) ->
    (VTPConfig, fp32 state dict under the reference names). An optional
    ``vtp.`` base-model prefix is stripped. The JAX package's native
    (orbax) format is not ported and raises."""
    with open(os.path.join(path, "config.json")) as f:
        cfg_dict = json.load(f)
    if cfg_dict.get("model_format") == "vtp_tpu":
        raise NotImplementedError(
            "native vtp_tpu (orbax) checkpoints are not ported; export an HF-layout checkpoint "
            "with vtp_tpu.convert.to_torch.save_hf_checkpoint")
    if config is None:
        config = VTPConfig.from_dict(cfg_dict)
    sd = load_safetensors_dir(path)
    if any(k.startswith("vtp.") for k in sd):
        sd = {k[len("vtp."):] if k.startswith("vtp.") else k: v for k, v in sd.items()}
    return config, {k: v.astype(np.float32, copy=False) for k, v in sd.items()}
