"""The VTP training meta-architecture facade (port of
``vtp_tpu/models/vtp_train_arch.py``; reference ``vtp/models/vtp.py:88-552``).

``VTP`` bundles the student (trunk, CLIP projection, text tower, pixel
decoder, DINO head) with a frozen EMA teacher copy and exposes the
reference class's public methods: the CLIP encoders and logits, the
teacher and student SSL outputs, the reconstruction outputs, ``forward``
and ``update_teacher``. It is a thin object layer over the towers; the
train loop itself is ``vtp_tpu_torch.train.step.build_train_step``. Where
the JAX facade takes a key, a training call takes a ``generator`` or the
trunk's ``draws`` (``VisionTransformer.sample_draws``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.models.dino_head import DinoHead
from vtp_tpu_torch.models.vtp_model import VTPModel, l2_normalize
from vtp_tpu_torch.ops.patchify import patch_tokens_to_4d
from vtp_tpu_torch.train.state import ema_update, make_teacher, student_parts
from vtp_tpu_torch.train.step import TrainConfig, init_train_modules


class VTP:
    """Object facade matching the reference VTP class's public methods.
    ``model`` and ``dino_head`` default to fresh ones from ``generator``
    on ``device``; the teacher starts as a copy of them."""

    def __init__(self, config: VTPConfig, train_config: Optional[TrainConfig] = None,
                 model: Optional[VTPModel] = None, dino_head: Optional[DinoHead] = None,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16, device="cuda"):
        self.config = config
        self.train_config = train_config or TrainConfig()
        self.compute_dtype = compute_dtype
        if model is None:
            model, dino_head = init_train_modules(config, self.train_config, generator, device)
        self.model, self.dino_head = model, dino_head
        self.enable_teacher = self.train_config.train_ssl and dino_head is not None
        self.teacher = make_teacher(model, dino_head) if self.enable_teacher else None
        # per-objective drop rates (vtp.py:206-208)
        self.clip_drop_rate = self.train_config.clip_drop_rate
        self.ssl_drop_rate = self.train_config.ssl_drop_rate
        self.rec_drop_rate = self.train_config.rec_drop_rate

    def _trunk_kw(self, training: bool, drop_rate: float, generator, draws) -> Dict:
        return dict(training=training, drop_ratio=drop_rate if training else 0.0,
                    generator=generator, draws=draws)

    # ------------------------------------------------------------ CLIP

    def encode_image(self, image: torch.Tensor, normalize: bool = False, *,
                     training: bool = False, generator: Optional[torch.Generator] = None,
                     draws=None) -> torch.Tensor:
        """(vtp.py:275-293)."""
        feat = self.model.clip_image_embedding(
            image, self.compute_dtype,
            **self._trunk_kw(training, self.clip_drop_rate, generator, draws))
        return l2_normalize(feat) if normalize else feat

    def encode_text(self, text: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        """(vtp.py:295-312): the pooled feature only."""
        out = self.model.text(text, normalize=normalize, compute_dtype=self.compute_dtype)
        return out[0] if isinstance(out, tuple) else out

    def get_logits(self, image: torch.Tensor, text: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(vtp.py:314-321)."""
        img = self.encode_image(image, normalize=True)
        txt = self.encode_text(text, normalize=True)
        logits = torch.exp(self.model.logit_scale) * img @ txt.t()
        if self.model.logit_bias is not None:
            logits = logits + self.model.logit_bias
        return logits, logits.t()

    # ------------------------------------------------------------- SSL

    @torch.no_grad()
    def get_teacher_forward_outputs(self, global_crops: torch.Tensor, n_global_crops: int,
                                    mask_indices: torch.Tensor, n_masked_weight: torch.Tensor
                                    ) -> Dict[str, torch.Tensor]:
        """EMA-teacher targets with the crop swap and the masked-patch gather
        (vtp.py:410-450); ``mask_indices`` is the upperbound-padded buffer,
        ``n_masked_weight`` its weights."""
        if not self.enable_teacher:
            return {}
        out = self.teacher["trunk"].forward_features(
            global_crops, use_bottleneck=not self.config.vision_bottleneck_ae_only,
            compute_dtype=self.compute_dtype)
        bc = global_crops.shape[0] // n_global_crops
        cls = out["x_norm_clstoken"]
        masked = out["x_norm_patchtokens"].reshape(-1, cls.shape[-1])[mask_indices]
        head = self.teacher["dino_head"]
        return {"teacher_cls_tokens_after_head": head(torch.cat([cls[bc:], cls[:bc]])),
                "masked_teacher_patch_tokens_after_head": head(masked),
                "mask_weight": n_masked_weight}

    def get_student_ssl_outputs(self, global_crops: torch.Tensor, local_crops: torch.Tensor,
                                masks: torch.Tensor, mask_indices: torch.Tensor, *,
                                training: bool = True,
                                generator: Optional[torch.Generator] = None,
                                draws=None) -> Dict[str, torch.Tensor]:
        """The masked-global and local multi-crop student pass (vtp.py:452-484)."""
        if not self.enable_teacher:
            return {}
        s_global, s_local = self.model.trunk.forward_features(
            [global_crops, local_crops], masks=[masks, None],
            use_bottleneck=not self.config.vision_bottleneck_ae_only,
            compute_dtype=self.compute_dtype,
            **self._trunk_kw(training, self.ssl_drop_rate, generator, draws))
        g_cls, l_cls = s_global["x_norm_clstoken"], s_local["x_norm_clstoken"]
        masked = s_global["x_norm_patchtokens"].reshape(-1, g_cls.shape[-1])[mask_indices]
        head = self.dino_head
        return {"student_local_cls_tokens_after_head": head(l_cls),
                "student_global_cls_tokens_after_head": head(g_cls),
                "student_global_cls_tokens": g_cls,
                "student_global_masked_patch_tokens_after_head": head(masked)}

    # --------------------------------------------------------------- rec

    def get_reconstruction_outputs(self, image: torch.Tensor, *, training: bool = False,
                                   generator: Optional[torch.Generator] = None,
                                   draws=None) -> Dict[str, torch.Tensor]:
        """(vtp.py:487-512)."""
        if not self.train_config.train_reconstruction:
            return {}
        _, _, H, W = image.shape
        out = self.model.trunk.forward_features(
            image, use_bottleneck=True, compute_dtype=self.compute_dtype,
            **self._trunk_kw(training, self.rec_drop_rate, generator, draws))
        p = self.config.vision_patch_size
        latents = patch_tokens_to_4d(out["x_norm_patchtokens"], H // p, W // p)
        rec = self.model.pixel_decoder(latents, compute_dtype=self.compute_dtype)
        return {"reconstructed_image": rec, "target_image": image}

    # ------------------------------------------------------------ control

    def forward(self, image=None, text=None, ssl_dict=None, reconstruction_image=None,
                forward_type: str = "clip"):
        """(vtp.py:323-338)."""
        if forward_type == "clip":
            out = {
                "image_features": self.encode_image(image, True) if image is not None else None,
                "text_features": self.encode_text(text, True) if text is not None else None,
                "logit_scale": torch.exp(self.model.logit_scale),
            }
            if self.model.logit_bias is not None:
                out["logit_bias"] = self.model.logit_bias
            return out
        if forward_type == "ssl":
            teacher = self.get_teacher_forward_outputs(
                ssl_dict["global_crops"], ssl_dict.get("n_global_crops", 2),
                ssl_dict["mask_indices"], ssl_dict["mask_weight"])
            student = self.get_student_ssl_outputs(
                ssl_dict["global_crops"], ssl_dict["local_crops"], ssl_dict["masks"],
                ssl_dict["mask_indices"])
            return teacher, student
        if forward_type == "rec":
            return self.get_reconstruction_outputs(reconstruction_image)
        raise ValueError(f"Invalid forward type: {forward_type}")

    __call__ = forward

    def update_teacher(self, momentum: float) -> None:
        """EMA lerp of trunk + proj + dino_head (vtp.py:388-401)."""
        if self.enable_teacher:
            ema_update(self.teacher, student_parts(self.model, self.dino_head), momentum)
