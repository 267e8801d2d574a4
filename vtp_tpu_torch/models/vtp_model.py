"""VTPModel: the reconstruction roundtrip, the CLIP towers and the
feature API (port of ``vtp_tpu/models/vtp_model.py``: ``l2_normalize``
:41, ``init_vtp_params`` :125, ``get_last_layer_feature`` :155,
``get_intermediate_layers_feature`` :168, ``get_clip_image_feature`` :185,
``get_clip_text_feature`` :207, ``get_clip_logits`` :222,
``get_reconstruction_latents`` :241, ``get_latents_decoded_images`` :255,
``VTPModel`` :276, its ``from_torch_checkpoint`` :297 and ``forward``
:379).

A config with ``vision_qkv_head_major > 1`` (the layout a tensor-parallel
run writes) builds a trunk whose qkv columns are in that head-major
layout, as the JAX package keeps them: ``init`` draws canonical weights and
permutes them (``init_vtp_params`` :125-135), ``load_numpy_state_dict``
permutes a canonical state dict into it, and ``convert.export_state_dict``
permutes back.

The dtype protocol is the reference's rFID protocol: encode in bf16
(inputs and weights cast at each GEMM, fp32 norm statistics and softmax),
decode in exact fp32 (``tools/test_reconstruction_hf.py:366-370``). As in
the JAX ``VTPModel``, ``decode_precision="high"`` decodes in fp32 with the
bf16x3 split, and a ``decode_dtype`` (bf16) decodes in that dtype instead.
With ``train_clip`` the model also holds ``visual_proj``, the text tower
and ``logit_scale`` (``logit_bias`` for SigLIP configs), under the
reference checkpoint's names. ``quantize_for_serving`` (:314) gives the
int8 W8A8 serving tier. ``parallel.sharding.parallelize_model`` spreads a
model over a mesh: its towers' slabs over a model axis, and over a seq or
pipe axis the trunk's and the decoder's token split or pipeline stages
(their ``cp`` / ``pp``), every entry point then running on each rank.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.models.initializers import trunc_normal_
from vtp_tpu_torch.models.pixel_decoder import PixelDecoder, PixelDecoderConfig
from vtp_tpu_torch.models.text_encoder import TextConfig, TextTransformer
from vtp_tpu_torch.models.vit import ViTConfig, VisionTransformer
from vtp_tpu_torch.ops.ffn import linear
from vtp_tpu_torch.ops.patchify import patch_tokens_to_4d
from vtp_tpu_torch.ops.precision import check_precision
from vtp_tpu_torch.parallel.sharding import is_trunk_qkv_key, permute_qkv_state_dict
from vtp_tpu_torch.utils.quantization import quantize_matmul_params, shallow_copy

DEFAULT_LOGIT_SCALE = math.log(1 / 0.07)
# Checkpoint keys of the text tower, which lives under ``text.`` here
TEXT_PREFIXES = ("token_embedding.", "positional_embedding", "cls_emb", "text_transformer.",
                 "ln_final.", "text_projection")
# Keys of the CLIP towers, set aside on load when the config builds none
CLIP_PREFIXES = TEXT_PREFIXES + ("visual_proj.", "logit_scale", "logit_bias")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics (norm clamped at eps), with a sqrt that
    stays finite on an exactly-zero row."""
    sq = (x * x).sum(-1, keepdim=True)
    return x / torch.clamp(torch.sqrt(torch.clamp(sq, min=eps * eps)), min=eps)


def checkpoint_name(name: str) -> str:
    """The reference checkpoint's key for the port's state-dict key."""
    return name[len("text."):] if name.startswith("text.") else name


def model_name(key: str) -> str:
    """The port's state-dict key for a reference checkpoint key."""
    return "text." + key if key.startswith(TEXT_PREFIXES) else key


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
        rope_shift_coords=cfg.rope_shift_coords,
        rope_jitter_coords=cfg.rope_jitter_coords,
        rope_rescale_coords=cfg.rope_rescale_coords,
        rope_dtype=cfg.rope_dtype,
        qkv_head_major=cfg.vision_qkv_head_major,
    )


def text_config_from(cfg: VTPConfig) -> TextConfig:
    return TextConfig(
        context_length=cfg.text_context_length,
        vocab_size=cfg.text_vocab_size,
        width=cfg.text_embed_dim,
        heads=cfg.text_num_heads,
        layers=cfg.text_depth,
        mlp_ratio=cfg.text_mlp_ratio,
        ls_init_value=cfg.text_ls_init_value,
        output_dim=cfg.text_embed_dim,
        embed_cls=cfg.text_embed_cls,
        no_causal_mask=cfg.text_no_causal_mask,
        pad_id=cfg.text_pad_id,
        pool_type=cfg.text_pool_type,
        proj_type=cfg.text_proj_type,
        proj_bias=cfg.text_proj_bias,
        quick_gelu=cfg.text_quick_gelu,
        output_tokens=cfg.text_output_tokens,
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
    """Vision trunk (``trunk.*``), pixel decoder (``pixel_decoder.*``) and,
    with ``train_clip``, ``visual_proj``, the text tower (``text.*``, the
    checkpoint's top-level text keys) and ``logit_scale``.

    The constructor allocates the parameters on ``device`` without
    initialising them; use :meth:`init` for random weights,
    :meth:`from_checkpoint` for an HF-layout checkpoint or
    :meth:`load_numpy_state_dict` for converted weights. ``encode_dtype``
    is the encode's and the CLIP towers' compute dtype (None: fp32);
    ``decode_dtype`` None decodes in fp32 at ``decode_precision``
    ("float32" exact, "high" bf16x3), a dtype decodes in it."""

    def __init__(self, config: VTPConfig, device="cuda",
                 encode_dtype: Optional[torch.dtype] = torch.bfloat16,
                 decode_dtype: Optional[torch.dtype] = None,
                 decode_precision: str = "float32"):
        super().__init__()
        check_precision(decode_precision)
        self.config = config
        self.encode_dtype = encode_dtype
        self.decode_dtype = decode_dtype
        self.decode_precision = decode_precision
        with torch.device("meta"):
            self.trunk = VisionTransformer(vit_config_from(config))
            self.pixel_decoder = (PixelDecoder(decoder_config_from(config))
                                  if config.train_reconstruction else None)
            self.visual_proj = self.text = self.logit_scale = self.logit_bias = None
            if config.train_clip:
                proj_in = (config.vision_embed_dim if config.vision_bottleneck_ae_only
                           else config.vision_feature_bottleneck)
                self.visual_proj = nn.Linear(proj_in, config.text_embed_dim, bias=False)
                self.text = TextTransformer(text_config_from(config))
                lshape = (1,) if config.nonscalar_logit_scale else ()
                self.logit_scale = nn.Parameter(torch.empty(lshape))
                if config.init_logit_bias is not None:
                    self.logit_bias = nn.Parameter(torch.empty(lshape))
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
        if model.text is not None:
            with torch.no_grad():
                trunc_normal_(model.visual_proj.weight, 0.02, generator)
                model.text.reset_parameters(generator)
                scale = config.init_logit_scale
                model.logit_scale.fill_(DEFAULT_LOGIT_SCALE if scale is None else scale)
                if model.logit_bias is not None:
                    model.logit_bias.fill_(config.init_logit_bias)
        if model.pixel_decoder is not None:
            model.pixel_decoder.reset_parameters(generator)
        if config.vision_qkv_head_major > 1:
            with torch.no_grad():
                own = model.state_dict()
                qkv = {k: v.clone() for k, v in own.items() if is_trunk_qkv_key(k)}
                for k, v in permute_qkv_state_dict(qkv, config.vision_num_heads,
                                                   config.vision_qkv_head_major).items():
                    own[k].copy_(v)
        return model

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda", config: Optional[VTPConfig] = None,
                        **kw) -> "VTPModel":
        """A model loaded from a checkpoint directory: HF layout
        (``config.json`` + ``*.safetensors``) or the JAX package's native
        format (``save_pretrained``: ``model_format: "vtp_tpu"``, canonical
        or head-major); ``convert.load_vtp_checkpoint``. The counterpart of
        ``from_torch_checkpoint``."""
        from vtp_tpu_torch.convert import load_vtp_checkpoint

        config, sd = load_vtp_checkpoint(path, config)
        model = cls(config, device=device, **kw)
        model.load_numpy_state_dict(sd)
        return model

    def quantize_for_serving(self, parts: Sequence[str] = ("trunk",)) -> "VTPModel":
        """A new model with the linears of ``parts`` ("trunk", "text",
        "pixel_decoder") in int8 W8A8 (``utils.quantization``; the JAX
        ``quantize_for_serving``, :314-344). This model is unchanged, and the
        new one shares every tensor it does not quantize (the other towers,
        ``visual_proj``, ``logit_scale``, the norms and tokens). The trunk's
        ``patch_embed`` and ``feature_bottleneck`` stay float; a head-major
        trunk's permuted qkv quantizes as it stands (per-output-channel
        scales follow the column permutation).

        "pixel_decoder" is a serving tier, not the rFID protocol: it sets
        ``decode_dtype`` to bf16, so int8 decoder weights never pose as the
        exact or "high" fp32 decode. The default keeps the fp32 decode."""
        new = shallow_copy(self)
        for part in parts:
            if part not in ("trunk", "text", "pixel_decoder") or getattr(self, part) is None:
                raise ValueError(f"no part {part!r} to quantize in this model")
            setattr(new, part, quantize_matmul_params(getattr(self, part)))
        if "pixel_decoder" in parts:
            new.decode_dtype = torch.bfloat16
        return new

    @torch.no_grad()
    def load_numpy_state_dict(self, sd: Dict[str, np.ndarray]) -> None:
        """Load a reference-named, canonical-[Q|K|V] state dict of numpy
        arrays (as ``vtp_tpu.convert.to_torch.export_state_dict`` writes,
        the layout of released checkpoints), permuted into the config's
        qkv layout. Keys of the towers this model does not build are set
        aside; any other unmatched or missing key, or a shape mismatch,
        raises."""
        cfg = self.config
        sd = permute_qkv_state_dict(sd, cfg.vision_num_heads, cfg.vision_qkv_head_major)
        own = self.state_dict()
        unbuilt = CLIP_PREFIXES if self.text is None else ()
        unexpected, loaded, masks = [], set(), {}
        for key, value in sd.items():
            name = model_name(key)
            if name in own:
                value = np.asarray(value)
                if tuple(value.shape) != tuple(own[name].shape):
                    raise ValueError(f"{name}: checkpoint shape {value.shape} "
                                     f"!= model shape {tuple(own[name].shape)}")
                own[name].copy_(torch.tensor(value))
                loaded.add(name)
            elif name.endswith(".attn.qkv.bias_mask") and name[:-5] in own:
                masks[name[:-5]] = value  # LinearKMaskedBias: folded into the bias
            elif not key.startswith(unbuilt):
                unexpected.append(key)
        missing = sorted(set(own) - loaded)
        if unexpected or missing:
            raise KeyError(f"state dict mismatch: unexpected {sorted(unexpected)}, "
                           f"missing {missing}")
        for name, mask in masks.items():
            own[name].mul_(torch.tensor(np.asarray(mask), dtype=torch.float32, device=own[name].device))

    def clip_image_embedding(self, image: torch.Tensor,
                             compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                             **trunk_kw) -> torch.Tensor:
        """The un-normalized CLIP image feature: the cls (or mean patch)
        feature through ``visual_proj``; ``trunk_kw`` go to the trunk."""
        cfg = self.config
        if self.visual_proj is None:
            raise ValueError("this config has no CLIP towers (train_clip=False)")
        out = self.trunk.forward_features(image, use_bottleneck=not cfg.vision_bottleneck_ae_only,
                                          compute_dtype=compute_dtype, **trunk_kw)
        if cfg.vision_clip_feat == "cls":
            feat = out["x_norm_clstoken"]
        elif cfg.vision_clip_feat == "pooled":
            feat = out["x_norm_patchtokens"].mean(1)
        else:
            raise ValueError(f"Invalid vision_clip_feat: {cfg.vision_clip_feat}")
        return linear(feat, self.visual_proj.weight, None, compute_dtype)

    @torch.no_grad()
    def get_clip_image_feature(self, image: torch.Tensor, normalize: bool = True,
                               compute_dtype: Optional[torch.dtype] = torch.bfloat16
                               ) -> torch.Tensor:
        """(modeling_vtp.py:244-276)."""
        feat = self.clip_image_embedding(image, compute_dtype)
        return l2_normalize(feat) if normalize else feat

    @torch.no_grad()
    def get_clip_text_feature(self, text: torch.Tensor, normalize: bool = True,
                              compute_dtype: Optional[torch.dtype] = torch.bfloat16
                              ) -> torch.Tensor:
        """(modeling_vtp.py:278-310): the pooled feature only."""
        if self.text is None:
            raise ValueError("this config has no CLIP towers (train_clip=False)")
        out = self.text(text, normalize=normalize, compute_dtype=compute_dtype)
        return out[0] if isinstance(out, tuple) else out

    @torch.no_grad()
    def get_clip_logits(self, image: torch.Tensor, text: torch.Tensor,
                        compute_dtype: Optional[torch.dtype] = torch.bfloat16
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(modeling_vtp.py:312-333): (logits per image, logits per text)."""
        img = self.get_clip_image_feature(image, True, compute_dtype)
        txt = self.get_clip_text_feature(text, True, compute_dtype)
        logits = torch.exp(self.logit_scale) * img.float() @ txt.float().t()
        if self.logit_bias is not None:
            logits = logits + self.logit_bias
        return logits, logits.t()

    @torch.no_grad()
    def get_last_layer_feature(self, image: torch.Tensor, use_bottleneck: bool = False
                               ) -> Dict[str, torch.Tensor]:
        """(modeling_vtp.py:184-212): {"cls_token", "patch_tokens"}."""
        out = self.trunk.forward_features(image, use_bottleneck=use_bottleneck,
                                          compute_dtype=self.encode_dtype)
        return {"cls_token": out["x_norm_clstoken"], "patch_tokens": out["x_norm_patchtokens"]}

    @torch.no_grad()
    def get_intermediate_layers_feature(self, image: torch.Tensor,
                                        n: Union[int, Sequence[int]] = 1, reshape: bool = False,
                                        return_class_token: bool = False, norm: bool = True
                                        ) -> Tuple:
        """(modeling_vtp.py:214-240): always bypasses the bottleneck."""
        return self.trunk.get_intermediate_layers(image, n, reshape=reshape,
                                                  return_class_token=return_class_token,
                                                  norm=norm, compute_dtype=self.encode_dtype)

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
                                   precision: Optional[str] = None) -> torch.Tensor:
        """Latents -> (B, 3, H, W) RGB (modeling_vtp.py:362-377): in fp32 at
        ``precision`` (default: the model's ``decode_precision``), or in
        ``decode_dtype`` when the model has one."""
        if self.pixel_decoder is None:
            raise ValueError("this config has no pixel decoder (train_reconstruction=False)")
        if self.decode_dtype is not None:
            return self.pixel_decoder(latents, compute_dtype=self.decode_dtype)
        return self.pixel_decoder(latents, precision=precision or self.decode_precision)

    def forward(self, image: Optional[torch.Tensor] = None, text: Optional[torch.Tensor] = None,
                forward_type: str = "clip") -> Dict[str, torch.Tensor]:
        """(modeling_vtp.py:399-472): "clip" (normalized features and the
        logit scale), "rec" (latents and their decode) or "feature" (the
        bottlenecked last-layer feature)."""
        if forward_type == "clip":
            result = {}
            if image is not None:
                result["image_features"] = self.get_clip_image_feature(
                    image, True, self.encode_dtype)
            if text is not None:
                result["text_features"] = self.get_clip_text_feature(text, True, self.encode_dtype)
            result["logit_scale"] = torch.exp(self.logit_scale.detach())
            if self.logit_bias is not None:
                result["logit_bias"] = self.logit_bias.detach()
            return result
        if forward_type == "rec":
            latents = self.get_reconstruction_latents(image)
            return {"latents": latents,
                    "reconstructed_image": self.get_latents_decoded_images(latents),
                    "target_image": image}
        if forward_type == "feature":
            return self.get_last_layer_feature(image, use_bottleneck=True)
        raise ValueError(f"Invalid forward_type: {forward_type}")
