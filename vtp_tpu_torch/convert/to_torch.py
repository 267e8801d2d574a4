"""Write a VTPModel as an HF-layout checkpoint (port of
``vtp_tpu/convert/to_torch.py:162-174``, ``save_hf_checkpoint``):
``config.json`` and ``model.safetensors`` under the reference
checkpoint's names, every tensor in fp32, which the reference's
``VTPModel.from_pretrained`` and the JAX package's ``load_vtp_checkpoint``
read."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from vtp_tpu_torch.convert.safetensors_io import save_safetensors


def export_state_dict(model) -> Dict[str, np.ndarray]:
    """The model's state as fp32 numpy arrays under the reference names."""
    from vtp_tpu_torch.models.vtp_model import checkpoint_name

    return {checkpoint_name(k): v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def save_hf_checkpoint(path: str, model) -> None:
    """Write ``model`` (a ``VTPModel``) to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    # the port holds canonical [Q|K|V] columns only
    hf_cfg = {"model_type": "vtp", **model.config.to_dict(), "vision_qkv_head_major": 1}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    save_safetensors(os.path.join(path, "model.safetensors"), export_state_dict(model))
