"""Write a VTPModel as an HF-layout checkpoint (port of
``vtp_tpu/convert/to_torch.py:162-174``, ``save_hf_checkpoint``):
``config.json`` and ``model.safetensors`` under the reference
checkpoint's names, every tensor in fp32, which the reference's
``VTPModel.from_pretrained`` and the JAX package's ``load_vtp_checkpoint``
read. The weights are always canonical [Q|K|V]: a head-major trunk is
permuted back, and the config says ``vision_qkv_head_major: 1``.

``export_params_state_dict`` is the port's numpy copy of the JAX
package's ``export_state_dict`` (:79-160): a parameter tree in the JAX
layout (stacked ``(depth, ...)`` blocks, ``(in, out)`` kernels, the
declared qkv layout) -> the canonical reference-named state dict. An int8
tree (``vtp_tpu/utils/quantization.quantize_matmul_params``: ``{q, scale,
bias}`` in place of ``{kernel, bias}``) gives the names and layout of a
``VTPModel.quantize_for_serving`` model (``<linear>.weight.q`` int8
``(out, in)``, ``<linear>.weight.scale``), which loads it with
``load_numpy_state_dict``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.convert.safetensors_io import save_safetensors
from vtp_tpu_torch.parallel.sharding import permute_qkv_state_dict, permute_trunk_qkv

Array = np.ndarray


def export_state_dict(model) -> Dict[str, np.ndarray]:
    """The model's state as fp32 numpy arrays under the reference names,
    with canonical [Q|K|V] qkv columns. A tensor-parallelized model's slabs
    are gathered first (every rank of its mesh calls this)."""
    from vtp_tpu_torch.models.vtp_model import checkpoint_name
    from vtp_tpu_torch.parallel.sharding import gather_state_dict

    cfg = model.config
    sd = {checkpoint_name(k): v.detach().float().cpu().numpy()
          for k, v in gather_state_dict(model).items()}
    return permute_qkv_state_dict(sd, cfg.vision_num_heads, cfg.vision_qkv_head_major,
                                  inverse=True)


def _t(kernel) -> Array:
    """JAX kernel (in, out) -> torch Linear weight (out, in)."""
    return np.ascontiguousarray(np.asarray(kernel, np.float32).T)


def _np(x) -> Array:
    return np.asarray(x, np.float32)


def _norm_out(sd: Dict[str, Array], prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    if p.get("bias") is not None:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _weight_out(sd: Dict[str, Array], name: str, p: dict, conv: bool = False) -> None:
    """A linear's weight under ``name``: a float kernel ``(in, out)`` as
    ``(out, in)`` (``(out, in, 1, 1)`` for a 1x1 ``conv``), or an int8 one
    (``{q, scale}``, the JAX ``quantize_kernel``) as ``name.q`` ``(out, in)``
    int8 and ``name.scale``, the port's ``Int8Weight``."""
    if "q" in p:
        sd[f"{name}.q"] = np.ascontiguousarray(np.asarray(p["q"], np.int8).T)
        sd[f"{name}.scale"] = _np(p["scale"])
    else:
        sd[name] = _t(p["kernel"])[..., None, None] if conv else _t(p["kernel"])


def _linear_out(sd: Dict[str, Array], prefix: str, p: dict, conv: bool = False) -> None:
    _weight_out(sd, f"{prefix}.weight", p, conv)
    if p.get("bias") is not None:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _layer(tree, i: int):
    """Layer ``i`` of a stacked ``(depth, ...)`` tree; None leaves stay None."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return None if tree is None else tree[i]


def _blocks_out(sd: Dict[str, Array], prefix: str, stacked: dict, depth: int) -> None:
    for i in range(depth):
        blk = _layer(stacked, i)
        p = f"{prefix}.{i}"
        _norm_out(sd, f"{p}.norm1", blk["norm1"])
        _norm_out(sd, f"{p}.norm2", blk["norm2"])
        _linear_out(sd, f"{p}.attn.qkv", blk["attn"]["qkv"])
        _linear_out(sd, f"{p}.attn.proj", blk["attn"]["proj"])
        if "q_norm" in blk["attn"]:
            _norm_out(sd, f"{p}.attn.q_norm", blk["attn"]["q_norm"])
            _norm_out(sd, f"{p}.attn.k_norm", blk["attn"]["k_norm"])
        mlp = blk["mlp"]
        if "w12" in mlp:  # un-fuse the serving-time fusion
            k = np.asarray(mlp["w12"]["kernel"], np.float32)
            half = k.shape[-1] // 2
            w1 = {"kernel": k[..., :half], "bias": None}
            w2 = {"kernel": k[..., half:], "bias": None}
            if mlp["w12"].get("bias") is not None:
                b = np.asarray(mlp["w12"]["bias"], np.float32)
                w1["bias"], w2["bias"] = b[:half], b[half:]
            mlp = {"w1": w1, "w2": w2, "w3": mlp["w3"]}
        if "w1" in mlp:
            _linear_out(sd, f"{p}.mlp.w1", mlp["w1"])
            _linear_out(sd, f"{p}.mlp.w2", mlp["w2"])
            _linear_out(sd, f"{p}.mlp.w3", mlp["w3"])
        else:
            _linear_out(sd, f"{p}.mlp.fc1", mlp["fc1"])
            _linear_out(sd, f"{p}.mlp.fc2", mlp["fc2"])
        if "ls1" in blk:
            sd[f"{p}.ls1.gamma"] = _np(blk["ls1"]["gamma"])
            sd[f"{p}.ls2.gamma"] = _np(blk["ls2"]["gamma"])


def export_params_state_dict(params: dict, cfg: VTPConfig) -> Dict[str, Array]:
    """A JAX-layout parameter tree of numpy arrays -> the canonical
    reference-named fp32 state dict (``export_state_dict`` :79)."""
    sd: Dict[str, Array] = {}
    t = permute_trunk_qkv(params["trunk"], cfg.vision_num_heads, cfg.vision_qkv_head_major,
                          inverse=True)
    pk = cfg.vision_patch_size
    w = np.asarray(t["patch_embed"]["kernel"], np.float32)  # (C*p*p, D)
    sd["trunk.patch_embed.proj.weight"] = np.ascontiguousarray(w.T.reshape(-1, 3, pk, pk))
    sd["trunk.patch_embed.proj.bias"] = _np(t["patch_embed"]["bias"])
    sd["trunk.cls_token"] = _np(t["cls_token"])
    sd["trunk.mask_token"] = _np(t["mask_token"])
    sd["trunk.rope_embed.periods"] = _np(t["rope"]["periods"])
    if "storage_tokens" in t:
        sd["trunk.storage_tokens"] = _np(t["storage_tokens"])
    _blocks_out(sd, "trunk.blocks", t["blocks"], cfg.vision_depth)
    _norm_out(sd, "trunk.norm", t["norm"])
    if "cls_norm" in t:
        _norm_out(sd, "trunk.cls_norm", t["cls_norm"])
    if "local_cls_norm" in t:
        _norm_out(sd, "trunk.local_cls_norm", t["local_cls_norm"])
    if "feature_bottleneck" in t:
        sd["trunk.feature_bottleneck.weight"] = _t(t["feature_bottleneck"]["kernel"])

    if "visual_proj" in params:
        sd["visual_proj.weight"] = _t(params["visual_proj"]["kernel"])
    if "text" in params:
        tx = params["text"]
        sd["token_embedding.weight"] = _np(tx["token_embedding"])
        sd["positional_embedding"] = _np(tx["positional_embedding"])
        if "cls_emb" in tx:
            sd["cls_emb"] = _np(tx["cls_emb"])
        for i in range(cfg.text_depth):
            blk = _layer(tx["blocks"], i)
            p = f"text_transformer.resblocks.{i}"
            _norm_out(sd, f"{p}.ln_1", blk["ln_1"])
            _norm_out(sd, f"{p}.ln_2", blk["ln_2"])
            _weight_out(sd, f"{p}.attn.in_proj_weight", blk["attn"]["in_proj"])
            sd[f"{p}.attn.in_proj_bias"] = _np(blk["attn"]["in_proj"]["bias"])
            _linear_out(sd, f"{p}.attn.out_proj", blk["attn"]["out_proj"])
            _linear_out(sd, f"{p}.mlp.c_fc", blk["mlp"]["c_fc"])
            _linear_out(sd, f"{p}.mlp.c_proj", blk["mlp"]["c_proj"])
            if "ls_1" in blk:
                sd[f"{p}.ls_1.gamma"] = _np(blk["ls_1"]["gamma"])
                sd[f"{p}.ls_2.gamma"] = _np(blk["ls_2"]["gamma"])
        _norm_out(sd, "ln_final", tx["ln_final"])
        if "text_projection" in tx:
            # a Linear only with a bias, else a bare (width, out) matrix
            proj = tx["text_projection"]
            if proj.get("bias") is not None:
                _linear_out(sd, "text_projection", proj)
            elif "q" in proj:
                _weight_out(sd, "text_projection", proj)
            else:
                sd["text_projection"] = _np(proj["kernel"])
    if "logit_scale" in params:
        sd["logit_scale"] = _np(params["logit_scale"])
    if "logit_bias" in params:
        sd["logit_bias"] = _np(params["logit_bias"])

    if "pixel_decoder" in params:
        dec = params["pixel_decoder"]
        # (in, D) GEMM kernels -> the 1x1 convolutions' (D, in, 1, 1)
        _linear_out(sd, "pixel_decoder.proj_in", dec["proj_in"], conv=True)
        _linear_out(sd, "pixel_decoder.proj_out", dec["proj_out"], conv=True)
        sd["pixel_decoder.rope_embed.periods"] = _np(dec["rope"]["periods"])
        _blocks_out(sd, "pixel_decoder.blocks", dec["blocks"], cfg.decoder_depth)
        _norm_out(sd, "pixel_decoder.norm", dec["norm"])
    return sd


def save_hf_checkpoint(path: str, model) -> None:
    """Write ``model`` (a ``VTPModel``) to the directory ``path``; a
    tensor-parallelized one is gathered on every rank and written by rank 0."""
    from vtp_tpu_torch.parallel.multihost import is_main_process

    sd = export_state_dict(model)
    if not is_main_process():
        return
    os.makedirs(path, exist_ok=True)
    # export_state_dict writes canonical [Q|K|V] columns, so the config must
    # not claim a head-major layout
    hf_cfg = {"model_type": "vtp", **model.config.to_dict(), "vision_qkv_head_major": 1}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    save_safetensors(os.path.join(path, "model.safetensors"), sd)
