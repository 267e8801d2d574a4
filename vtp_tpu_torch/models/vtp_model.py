"""VTPModel: the reconstruction roundtrip (port of
``vtp_tpu/models/vtp_model.py:241`` ``get_reconstruction_latents``,
``:255`` ``get_latents_decoded_images`` and ``:276-300`` ``VTPModel``).

The dtype protocol is the reference's rFID protocol: encode in bf16
(inputs and weights cast at each GEMM, fp32 norm statistics and softmax),
decode in exact fp32 (``tools/test_reconstruction_hf.py:366-370``). The
text tower and the CLIP head are not built yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.models.pixel_decoder import PixelDecoder, PixelDecoderConfig
from vtp_tpu_torch.models.vit import ViTConfig, VisionTransformer
from vtp_tpu_torch.ops.patchify import patch_tokens_to_4d

# State-dict keys of towers this model does not build; a checkpoint's
# entries under them are set aside on load.
UNBUILT_PREFIXES = (
    "visual_proj.", "token_embedding.", "positional_embedding", "cls_emb",
    "text_transformer.", "ln_final.", "text_projection", "logit_scale", "logit_bias",
)


def vit_config_from(cfg: VTPConfig) -> ViTConfig:
    return ViTConfig(
        embed_dim=cfg.vision_embed_dim,
        depth=cfg.vision_depth,
        num_heads=cfg.vision_num_heads,
        patch_size=cfg.vision_patch_size,
        ffn_ratio=cfg.vision_mlp_ratio,
        ffn_layer=cfg.vision_ffn_layer,
        norm_layer=cfg.vision_norm_layer,
        layerscale_init=cfg.vision_init_values,
        use_qk_norm=cfg.vision_use_qk_norm,
        qkv_bias=cfg.vision_qkv_bias,
        proj_bias=cfg.vision_proj_bias,
        ffn_bias=cfg.vision_ffn_bias,
        n_storage_tokens=cfg.vision_n_storage_tokens,
        mask_k_bias=cfg.vision_mask_k_bias,
        untie_cls_and_patch_norms=cfg.vision_untie_cls_and_patch_norms,
        untie_global_and_local_cls_norm=cfg.vision_untie_global_and_local_cls_norm,
        feature_bottleneck=cfg.vision_feature_bottleneck,
        rope_base=cfg.rope_base,
        rope_min_period=cfg.rope_min_period,
        rope_max_period=cfg.rope_max_period,
        rope_normalize_coords=cfg.rope_normalize_coords,
        rope_dtype=cfg.rope_dtype,
    )


def decoder_config_from(cfg: VTPConfig) -> PixelDecoderConfig:
    return PixelDecoderConfig(
        in_chans=cfg.vision_feature_bottleneck,
        out_chans=cfg.decoder_out_chans,
        upscale_factor=cfg.decoder_upscale_factor,
        embed_dim=cfg.decoder_embed_dim,
        depth=cfg.decoder_depth,
        num_heads=cfg.decoder_num_heads,
        ffn_ratio=cfg.decoder_mlp_ratio,
        ffn_layer=cfg.decoder_ffn_layer,
        norm_layer=cfg.decoder_norm_layer,
        layerscale_init=cfg.decoder_init_values,
        use_qk_norm=cfg.decoder_use_qk_norm,
        qkv_bias=cfg.decoder_qkv_bias,
        proj_bias=cfg.decoder_proj_bias,
        ffn_bias=cfg.decoder_ffn_bias,
        rope_base=cfg.rope_base,
        rope_min_period=cfg.rope_min_period,
        rope_max_period=cfg.rope_max_period,
        rope_normalize_coords=cfg.rope_normalize_coords,
        rope_dtype=cfg.rope_dtype,
    )


class VTPModel(nn.Module):
    """Vision trunk (``trunk.*``) and pixel decoder (``pixel_decoder.*``)
    under the reference checkpoints' parameter names.

    The constructor allocates the parameters on ``device`` without
    initialising them; use :meth:`init` for random weights or
    :meth:`load_numpy_state_dict` for converted ones."""

    def __init__(self, config: VTPConfig, device="cuda",
                 encode_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if config.vision_qkv_head_major != 1:
            raise NotImplementedError(
                "head-major qkv checkpoints (vision_qkv_head_major > 1) are not ported")
        self.config = config
        self.encode_dtype = encode_dtype
        with torch.device("meta"):
            self.trunk = VisionTransformer(vit_config_from(config))
            self.pixel_decoder = (PixelDecoder(decoder_config_from(config))
                                  if config.train_reconstruction else None)
        self.to_empty(device=device)

    @classmethod
    def init(cls, config: VTPConfig, generator: Optional[torch.Generator] = None,
             device="cuda", **kw) -> "VTPModel":
        """Random weights drawn from ``generator``, which lives on
        ``device`` (seeded with 0 when not given)."""
        model = cls(config, device=device, **kw)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        model.trunk.reset_parameters(generator)
        if model.pixel_decoder is not None:
            model.pixel_decoder.reset_parameters(generator)
        return model

    @torch.no_grad()
    def load_numpy_state_dict(self, sd: Dict[str, np.ndarray]) -> None:
        """Load a reference-named, canonical-[Q|K|V] state dict of numpy
        arrays (as ``vtp_tpu.convert.to_torch.export_state_dict`` writes,
        the layout of released checkpoints). Keys of the towers this model
        does not build are set aside; any other unmatched or missing key,
        or a shape mismatch, raises."""
        own = self.state_dict()
        unexpected, loaded, masks = [], set(), {}
        for name, value in sd.items():
            if name in own:
                value = np.asarray(value)
                if tuple(value.shape) != tuple(own[name].shape):
                    raise ValueError(f"{name}: checkpoint shape {value.shape} "
                                     f"!= model shape {tuple(own[name].shape)}")
                own[name].copy_(torch.tensor(value))
                loaded.add(name)
            elif name.endswith(".attn.qkv.bias_mask") and name[:-5] in own:
                masks[name[:-5]] = value  # LinearKMaskedBias: folded into the bias
            elif not name.startswith(UNBUILT_PREFIXES):
                unexpected.append(name)
        missing = sorted(set(own) - loaded)
        if unexpected or missing:
            raise KeyError(f"state dict mismatch: unexpected {sorted(unexpected)}, "
                           f"missing {missing}")
        for name, mask in masks.items():
            own[name].mul_(torch.tensor(np.asarray(mask), dtype=torch.float32, device=own[name].device))

    @torch.no_grad()
    def get_reconstruction_latents(self, image: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) image -> (B, d, H/p, W/p) bottleneck latents, encoded
        in ``encode_dtype`` (modeling_vtp.py:337-360)."""
        _, _, H, W = image.shape
        out = self.trunk.forward_features(image, use_bottleneck=True,
                                          compute_dtype=self.encode_dtype)
        p = self.config.vision_patch_size
        return patch_tokens_to_4d(out["x_norm_patchtokens"], H // p, W // p)

    @torch.no_grad()
    def get_latents_decoded_images(self, latents: torch.Tensor,
                                   precision: str = "float32") -> torch.Tensor:
        """Latents -> (B, 3, H, W) RGB, decoded in exact fp32
        (modeling_vtp.py:362-377)."""
        if self.pixel_decoder is None:
            raise ValueError("this config has no pixel decoder (train_reconstruction=False)")
        return self.pixel_decoder(latents, precision=precision)
