"""Model configuration for the VTP family (PyTorch port).

A copy of ``vtp_tpu/config.py``: the port imports nothing of the JAX
package, so it carries its own ``VTPConfig`` dataclass and presets.
``tests/test_torch_imports.py`` holds the two field sets and preset
values identical.

Field-compatible with the reference HF config
(``vtp/models/vtp_hf/configuration_vtp.py:67-114``) so that released
checkpoints' ``config.json`` files load directly.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class VTPConfig:
    """Configuration for a VTP model (vision trunk + pixel decoder + text tower).

    Defaults are VTP-Base-f16d64, matching the reference
    (configuration_vtp.py:67-114).
    """

    # General
    image_size: int = 256
    train_clip: bool = True
    train_reconstruction: bool = True

    # Vision encoder (DINOv3 ViT with bottleneck)
    vision_patch_size: int = 16
    vision_embed_dim: int = 768
    vision_depth: int = 12
    vision_num_heads: int = 12
    vision_mlp_ratio: float = 4.0
    vision_ffn_layer: str = "swiglu"
    vision_norm_layer: str = "rmsnorm"
    vision_init_values: Optional[float] = None
    vision_use_qk_norm: bool = False
    vision_feature_bottleneck: int = 64
    vision_bottleneck_ae_only: bool = True
    vision_clip_feat: str = "cls"
    vision_n_storage_tokens: int = 0
    vision_qkv_bias: bool = True
    vision_proj_bias: bool = True
    vision_ffn_bias: bool = True
    vision_mask_k_bias: bool = False
    vision_untie_cls_and_patch_norms: bool = False
    vision_untie_global_and_local_cls_norm: bool = False
    # Layout tag, not an architecture knob: the head-major TP factor
    # the trunk's packed qkv parameter columns are permuted for (1 =
    # canonical [Q|K|V]). The port loads only canonical checkpoints
    # (VTPModel.load_numpy_state_dict raises for > 1).
    vision_qkv_head_major: int = 1

    # RoPE (shared defaults between trunk and decoder; reference
    # embeddings.py:86-195)
    rope_base: Optional[float] = 100.0
    rope_min_period: Optional[float] = None
    rope_max_period: Optional[float] = None
    rope_normalize_coords: str = "separate"
    rope_shift_coords: Optional[float] = None
    rope_jitter_coords: Optional[float] = None
    rope_rescale_coords: Optional[float] = None
    rope_dtype: str = "bf16"

    # Text encoder (CLIP-style)
    text_context_length: int = 77
    text_vocab_size: int = 49408
    text_embed_dim: int = 768
    text_num_heads: int = 12
    text_depth: int = 12
    text_mlp_ratio: float = 4.0
    text_ls_init_value: Optional[float] = None
    text_embed_cls: bool = False
    text_pad_id: int = 0
    text_no_causal_mask: bool = False
    text_pool_type: str = "argmax"
    text_proj_type: str = "linear"
    text_proj_bias: bool = False
    text_output_tokens: bool = False
    text_quick_gelu: bool = False

    # Pixel decoder
    decoder_embed_dim: int = 768
    decoder_num_heads: int = 12
    decoder_depth: int = 12
    decoder_ffn_layer: str = "swiglu"
    decoder_norm_layer: str = "layernorm"
    decoder_init_values: Optional[float] = None
    decoder_use_qk_norm: bool = False
    decoder_upscale_factor: int = 16
    decoder_out_chans: int = 3
    decoder_mlp_ratio: float = 4.0
    decoder_qkv_bias: bool = True
    decoder_proj_bias: bool = True
    decoder_ffn_bias: bool = True

    # Runtime
    init_logit_scale: Optional[float] = None
    init_logit_bias: Optional[float] = None
    nonscalar_logit_scale: bool = False

    # ---------------------------------------------------------------- utils

    @property
    def vision_head_dim(self) -> int:
        return self.vision_embed_dim // self.vision_num_heads

    @property
    def decoder_head_dim(self) -> int:
        return self.decoder_embed_dim // self.decoder_num_heads

    @property
    def latent_grid(self) -> int:
        return self.image_size // self.vision_patch_size

    def replace(self, **kw: Any) -> "VTPConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VTPConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_hf_json(cls, path: str) -> "VTPConfig":
        """Load from a HF-style ``config.json`` written by the reference."""
        if os.path.isdir(path):
            path = os.path.join(path, "config.json")
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_vtp_yaml(cls, yaml_path: str, overrides=None) -> "VTPConfig":
        """Import a legacy VTP training YAML (the OmegaConf structure the
        reference converts in configuration_vtp.py:168-233:
        ``vtp_model.{vision_encoder,text_encoder,pixel_decoder}`` +
        ``training`` + ``data.image_size``).

        ``overrides``: OmegaConf-style CLI dotlist entries, e.g.
        ``["vtp_model.vision_encoder.depth=24", "data.image_size=512"]``
        (the reference's ``_load_vtp_config`` merge, vtp.py:119-152),
        applied on top of the file before conversion."""
        import yaml

        with open(yaml_path) as f:
            cfg = yaml.safe_load(f)
        for entry in overrides or []:
            dotted, _, raw = entry.partition("=")
            node = cfg
            keys = dotted.strip().split(".")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = yaml.safe_load(raw)
        vis = cfg["vtp_model"]["vision_encoder"]
        txt = cfg["vtp_model"]["text_encoder"]
        dec = cfg["vtp_model"]["pixel_decoder"]
        tr = cfg["training"]
        return cls(
            image_size=cfg["data"]["image_size"],
            train_clip=tr["train_clip"],
            train_reconstruction=tr["train_reconstruction"],
            vision_patch_size=vis["patch_size"],
            vision_embed_dim=vis["embed_dim"],
            vision_depth=vis["depth"],
            vision_num_heads=vis["num_heads"],
            vision_mlp_ratio=vis["mlp_ratio"],
            vision_ffn_layer=vis["ffn_layer"],
            vision_norm_layer=vis["norm_type"],
            vision_init_values=vis.get("init_values"),
            vision_use_qk_norm=vis.get("use_qk_norm", False),
            vision_feature_bottleneck=vis["vit_feature_bottleneck"],
            vision_bottleneck_ae_only=vis["bottleneck_ae_only"],
            vision_clip_feat=vis["clip_feat"],
            text_context_length=txt["context_length"],
            text_vocab_size=txt["vocab_size"],
            text_embed_dim=txt["embed_dim"],
            text_num_heads=txt["heads"],
            text_depth=txt["layers"],
            text_mlp_ratio=txt["mlp_ratio"],
            text_ls_init_value=txt.get("ls_init_value"),
            text_embed_cls=txt["embed_cls"],
            text_pad_id=txt["pad_id"],
            text_no_causal_mask=txt["no_causal_mask"],
            text_pool_type=txt["pool_type"],
            text_proj_type=txt["proj_type"],
            text_proj_bias=txt["proj_bias"],
            text_output_tokens=txt["output_tokens"],
            text_quick_gelu=txt["quick_gelu"],
            decoder_embed_dim=dec["embed_dim"],
            decoder_num_heads=dec["num_heads"],
            decoder_depth=dec["depth"],
            decoder_ffn_layer=dec["ffn_layer"],
            decoder_norm_layer=dec["norm_layer"],
            decoder_init_values=dec.get("layerscale_init"),
            decoder_use_qk_norm=dec.get("use_qk_norm", False),
            init_logit_scale=tr.get("init_logit_scale"),
            init_logit_bias=tr.get("init_logit_bias"),
            nonscalar_logit_scale=tr.get("nonscalar_logit_scale", False),
        )


def _decoder_for(size: str) -> Dict[str, Any]:
    # Reference pixel-decoder factories (decoders/pixel_decoder.py:166-214);
    # all VTP tokenizers use upscale_factor=16 (f16).
    dims = {
        "small": dict(decoder_embed_dim=384, decoder_depth=12, decoder_num_heads=6),
        "base": dict(decoder_embed_dim=768, decoder_depth=12, decoder_num_heads=12),
        "large": dict(decoder_embed_dim=1024, decoder_depth=24, decoder_num_heads=16),
    }
    return dims[size]


def vtp_small(**kw: Any) -> VTPConfig:
    """VTP-S-f16d64: ViT-S trunk (vision_transformer.py:328)."""
    base = dict(
        vision_embed_dim=384, vision_depth=12, vision_num_heads=6,
        text_embed_dim=768, text_depth=12, text_num_heads=12,
        **_decoder_for("small"),
    )
    base.update(kw)
    return VTPConfig(**base)


def vtp_base(**kw: Any) -> VTPConfig:
    """VTP-B-f16d64 (the reference config defaults)."""
    return VTPConfig(**kw)


def vtp_large(**kw: Any) -> VTPConfig:
    """VTP-L-f16d64: ViT-L trunk (vision_transformer.py:352)."""
    base = dict(
        vision_embed_dim=1024, vision_depth=24, vision_num_heads=16,
        text_embed_dim=768, text_depth=12, text_num_heads=12,
        **_decoder_for("large"),
    )
    base.update(kw)
    return VTPConfig(**base)


PRESETS = {
    "vtp-small": vtp_small,
    "vtp-base": vtp_base,
    "vtp-large": vtp_large,
}
