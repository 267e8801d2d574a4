"""The JAX package's native checkpoint format (port of
``vtp_tpu/checkpoint.py:25-89``: ``flatten_params``, ``unflatten_params``,
``save_pretrained``, ``load_pretrained``), without the ``safetensors``
package.

A native checkpoint is a directory with ``config.json`` (``model_format:
"vtp_tpu"`` and the ``VTPConfig`` fields) and one ``model.safetensors``
holding the JAX-layout parameter tree (``convert.from_torch``'s
``convert_state_dict``) flattened under ``/``-joined paths; a None leaf is
a zero-size tensor named ``<path>/__none__``. The trunk's qkv columns are
in the layout the config declares (``vision_qkv_head_major``), and the
RoPE periods are BF16 when the rope dtype is. The orbax train state of
``checkpoint.py`` is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.convert.safetensors_io import load_safetensors, save_safetensors

_SEP = "/"
_NONE_MARKER = "__none__"
# leaves of the tree in the rope dtype
ROPE_LEAVES = ("trunk/rope/periods", "pixel_decoder/rope/periods")


def flatten_params(params: Any) -> Dict[str, np.ndarray]:
    """A parameter tree (dicts, lists, arrays, None) -> {path: array}."""
    flat = {}

    def visit(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(path + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(path + (str(i),), v)
        elif node is None:
            flat[_SEP.join(path) + _SEP + _NONE_MARKER] = np.zeros((0,), np.float32)
        else:
            flat[_SEP.join(path)] = np.asarray(node)

    visit((), params)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Any:
    """{path: array} -> the nested dict tree (list indices stay string keys,
    as in the JAX package)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        if parts[-1] == _NONE_MARKER:
            parts, value = parts[:-1], None
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def save_pretrained(path: str, model) -> None:
    """Write ``model`` (a ``VTPModel``) as a native checkpoint to the
    directory ``path``: the JAX-layout tree of its weights in the config's
    qkv layout, fp32 leaves, the rope periods in BF16 when the rope dtype is
    bf16."""
    from vtp_tpu_torch.convert.from_torch import convert_state_dict
    from vtp_tpu_torch.convert.to_torch import export_state_dict
    from vtp_tpu_torch.parallel.sharding import permute_trunk_qkv

    cfg = model.config
    params = convert_state_dict(export_state_dict(model), cfg)
    params["trunk"] = permute_trunk_qkv(params["trunk"], cfg.vision_num_heads,
                                        cfg.vision_qkv_head_major)
    flat = flatten_params(params)
    bf16 = [k for k in ROPE_LEAVES if k in flat] if cfg.rope_dtype == "bf16" else []
    if cfg.rope_dtype == "fp16":
        flat.update({k: flat[k].astype(np.float16) for k in ROPE_LEAVES if k in flat})
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_format": "vtp_tpu", **cfg.to_dict()}, f, indent=2)
    save_safetensors(os.path.join(path, "model.safetensors"), flat, bf16=bf16)


def load_pretrained(path: str) -> Tuple[VTPConfig, Any]:
    """A native checkpoint directory -> (VTPConfig, parameter tree of numpy
    arrays; BF16 leaves as fp32). ``convert.load_vtp_checkpoint`` reads
    either format."""
    with open(os.path.join(path, "config.json")) as f:
        cfg_dict = json.load(f)
    if cfg_dict.get("model_format") != "vtp_tpu":
        raise ValueError(f"{path} is not a native checkpoint (no model_format \"vtp_tpu\"); "
                         f"read it with convert.load_vtp_checkpoint")
    config = VTPConfig.from_dict(cfg_dict)
    return config, unflatten_params(load_safetensors(os.path.join(path, "model.safetensors")))
