"""Load a VTP checkpoint (port of ``vtp_tpu/convert/from_torch.py:264-285``,
``load_vtp_checkpoint``): a released HF-layout checkpoint, or the JAX
package's native format (``config.json`` with ``model_format: "vtp_tpu"``
and one ``model.safetensors`` of the flattened parameter tree, which
``checkpoint.load_pretrained`` reads and ``export_params_state_dict``
turns into canonical reference names, un-permuting a head-major trunk).

The port keeps the reference checkpoint's names and torch layouts, so an
HF state dict feeds ``VTPModel.load_numpy_state_dict`` as it is, which
folds a ``LinearKMaskedBias.bias_mask`` into the qkv bias, casts the RoPE
periods to the rope dtype and permutes the qkv columns into the config's
layout.

``convert_state_dict`` is the port's numpy copy of the JAX package's
(:218-233): reference names -> a parameter tree in the JAX layout
(stacked ``(depth, ...)`` blocks, ``(in, out)`` kernels), which
``checkpoint.save_pretrained`` writes.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.convert.safetensors_io import load_safetensors

Array = np.ndarray


def _t(w: Array) -> Array:
    """torch Linear weight (out, in) -> kernel (in, out)."""
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _a(w: Array) -> Array:
    return np.asarray(w, np.float32)


def _conv1x1(w: Array) -> Array:
    """(out, in, 1, 1) conv -> (in, out) kernel."""
    return _t(w.reshape(w.shape[0], w.shape[1]))


def _norm(sd: Dict[str, Array], prefix: str) -> dict:
    p = {"scale": _a(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = _a(sd[f"{prefix}.bias"])
    return p


def _linear(sd: Dict[str, Array], prefix: str) -> dict:
    return {"kernel": _t(sd[f"{prefix}.weight"]),
            "bias": _a(sd[f"{prefix}.bias"]) if f"{prefix}.bias" in sd else None}


def _qkv(sd: Dict[str, Array], prefix: str) -> dict:
    bias = None
    if f"{prefix}.bias" in sd:
        bias = _a(sd[f"{prefix}.bias"])
        mask = sd.get(f"{prefix}.bias_mask")
        if mask is not None:
            bias = bias * _a(mask)
    return {"kernel": _t(sd[f"{prefix}.weight"]), "bias": bias}


def _stack(trees: list):
    """Stack identical-structure trees along a new axis 0; None stays None."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return None if first is None else np.stack(trees, axis=0)


def _vit_block(sd: Dict[str, Array], p: str, use_qk_norm: bool, has_ls: bool) -> dict:
    blk = {"norm1": _norm(sd, f"{p}.norm1"), "norm2": _norm(sd, f"{p}.norm2"),
           "attn": {"qkv": _qkv(sd, f"{p}.attn.qkv"), "proj": _linear(sd, f"{p}.attn.proj")}}
    if use_qk_norm:
        blk["attn"]["q_norm"] = _norm(sd, f"{p}.attn.q_norm")
        blk["attn"]["k_norm"] = _norm(sd, f"{p}.attn.k_norm")
    if f"{p}.mlp.w1.weight" in sd:
        blk["mlp"] = {"w1": _linear(sd, f"{p}.mlp.w1"), "w2": _linear(sd, f"{p}.mlp.w2"),
                      "w3": _linear(sd, f"{p}.mlp.w3")}
    else:
        blk["mlp"] = {"fc1": _linear(sd, f"{p}.mlp.fc1"), "fc2": _linear(sd, f"{p}.mlp.fc2")}
    if has_ls:
        blk["ls1"] = {"gamma": _a(sd[f"{p}.ls1.gamma"])}
        blk["ls2"] = {"gamma": _a(sd[f"{p}.ls2.gamma"])}
    return blk


def _count_blocks(sd: Dict[str, Array], prefix: str) -> int:
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    idx = {int(m.group(1)) for k in sd if (m := pat.match(k))}
    return max(idx) + 1 if idx else 0


def _blocks(sd: Dict[str, Array], prefix: str, depth: int) -> dict:
    depth = _count_blocks(sd, f"{prefix}.blocks") or depth
    use_qk_norm = f"{prefix}.blocks.0.attn.q_norm.weight" in sd
    has_ls = f"{prefix}.blocks.0.ls1.gamma" in sd
    return _stack([_vit_block(sd, f"{prefix}.blocks.{i}", use_qk_norm, has_ls)
                   for i in range(depth)])


def convert_trunk(sd: Dict[str, Array], cfg: VTPConfig, prefix: str = "trunk") -> dict:
    pw = sd[f"{prefix}.patch_embed.proj.weight"]
    params = {
        "patch_embed": {"kernel": _t(pw.reshape(pw.shape[0], -1)),
                        "bias": _a(sd[f"{prefix}.patch_embed.proj.bias"])},
        "cls_token": _a(sd[f"{prefix}.cls_token"]),
        "mask_token": _a(sd[f"{prefix}.mask_token"]),
        "rope": {"periods": _a(sd[f"{prefix}.rope_embed.periods"])},
        "blocks": _blocks(sd, prefix, cfg.vision_depth),
        "norm": _norm(sd, f"{prefix}.norm"),
    }
    if f"{prefix}.storage_tokens" in sd:
        params["storage_tokens"] = _a(sd[f"{prefix}.storage_tokens"])
    if f"{prefix}.cls_norm.weight" in sd:
        params["cls_norm"] = _norm(sd, f"{prefix}.cls_norm")
    if f"{prefix}.local_cls_norm.weight" in sd:
        params["local_cls_norm"] = _norm(sd, f"{prefix}.local_cls_norm")
    if f"{prefix}.feature_bottleneck.weight" in sd:
        params["feature_bottleneck"] = {"kernel": _t(sd[f"{prefix}.feature_bottleneck.weight"]),
                                        "bias": None}
    return params


def convert_pixel_decoder(sd: Dict[str, Array], cfg: VTPConfig,
                          prefix: str = "pixel_decoder") -> dict:
    p_in = {"kernel": _conv1x1(sd[f"{prefix}.proj_in.weight"]),
            "bias": _a(sd[f"{prefix}.proj_in.bias"]) if f"{prefix}.proj_in.bias" in sd else None}
    p_out = {"kernel": _conv1x1(sd[f"{prefix}.proj_out.weight"]),
             "bias": (_a(sd[f"{prefix}.proj_out.bias"]) if f"{prefix}.proj_out.bias" in sd
                      else None)}
    return {"proj_in": p_in, "proj_out": p_out,
            "rope": {"periods": _a(sd[f"{prefix}.rope_embed.periods"])},
            "blocks": _blocks(sd, prefix, cfg.decoder_depth),
            "norm": _norm(sd, f"{prefix}.norm")}


def convert_text(sd: Dict[str, Array], cfg: VTPConfig) -> dict:
    tx = "text_transformer.resblocks"
    if f"{tx}.0.ln_1.weight" not in sd and "transformer.resblocks.0.ln_1.weight" in sd:
        tx = "transformer.resblocks"  # legacy VTP naming (vtp.py:169)
    depth = _count_blocks(sd, tx) or cfg.text_depth
    has_ls = f"{tx}.0.ls_1.gamma" in sd

    def block(i: int) -> dict:
        p = f"{tx}.{i}"
        blk = {"ln_1": _norm(sd, f"{p}.ln_1"), "ln_2": _norm(sd, f"{p}.ln_2"),
               "attn": {"in_proj": {"kernel": _t(sd[f"{p}.attn.in_proj_weight"]),
                                    "bias": _a(sd[f"{p}.attn.in_proj_bias"])},
                        "out_proj": _linear(sd, f"{p}.attn.out_proj")},
               "mlp": {"c_fc": _linear(sd, f"{p}.mlp.c_fc"),
                       "c_proj": _linear(sd, f"{p}.mlp.c_proj")}}
        if has_ls:
            blk["ls_1"] = {"gamma": _a(sd[f"{p}.ls_1.gamma"])}
            blk["ls_2"] = {"gamma": _a(sd[f"{p}.ls_2.gamma"])}
        return blk

    params = {"token_embedding": _a(sd["token_embedding.weight"]),
              "positional_embedding": _a(sd["positional_embedding"]),
              "blocks": _stack([block(i) for i in range(depth)]),
              "ln_final": _norm(sd, "ln_final")}
    if "cls_emb" in sd:
        params["cls_emb"] = _a(sd["cls_emb"])
    if "text_projection.weight" in sd:
        params["text_projection"] = _linear(sd, "text_projection")
    elif "text_projection" in sd:
        # a bare (width, out) matrix used as x @ W: no transpose
        params["text_projection"] = {"kernel": _a(sd["text_projection"]), "bias": None}
    return params


def convert_state_dict(sd: Dict[str, Array], cfg: VTPConfig) -> dict:
    """Reference-named state dict (numpy) -> parameter tree in the JAX
    layout, fp32 leaves, the qkv columns as ``sd`` holds them."""
    params = {"trunk": convert_trunk(sd, cfg)}
    if "visual_proj.weight" in sd:
        params["visual_proj"] = {"kernel": _t(sd["visual_proj.weight"]), "bias": None}
    elif "proj.weight" in sd:  # legacy VTP naming (vtp.py:217)
        params["visual_proj"] = {"kernel": _t(sd["proj.weight"]), "bias": None}
    if any(k.startswith("pixel_decoder.") for k in sd):
        params["pixel_decoder"] = convert_pixel_decoder(sd, cfg)
    if "token_embedding.weight" in sd:
        params["text"] = convert_text(sd, cfg)
    if "logit_scale" in sd:
        params["logit_scale"] = _a(sd["logit_scale"])
    if "logit_bias" in sd:
        params["logit_bias"] = _a(sd["logit_bias"])
    return params


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
    (VTPConfig, fp32 state dict under the reference names, canonical qkv
    columns). An optional ``vtp.`` base-model prefix is stripped. A native
    checkpoint (``model_format: "vtp_tpu"``) goes through
    ``checkpoint.load_pretrained``; its config keeps its declared qkv
    layout, which ``VTPModel.load_numpy_state_dict`` permutes into."""
    with open(os.path.join(path, "config.json")) as f:
        cfg_dict = json.load(f)
    if cfg_dict.get("model_format") == "vtp_tpu":
        from vtp_tpu_torch.checkpoint import load_pretrained
        from vtp_tpu_torch.convert.to_torch import export_params_state_dict

        native_cfg, params = load_pretrained(path)
        return config or native_cfg, export_params_state_dict(params, native_cfg)
    if config is None:
        config = VTPConfig.from_dict(cfg_dict)
    sd = load_safetensors_dir(path)
    if any(k.startswith("vtp.") for k in sd):
        sd = {k[len("vtp."):] if k.startswith("vtp.") else k: v for k, v in sd.items()}
    return config, {k: v.astype(np.float32, copy=False) for k, v in sd.items()}
