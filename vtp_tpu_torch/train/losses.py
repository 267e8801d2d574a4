"""Training objectives of the VTP meta-architecture (port of
``vtp_tpu/train/losses.py``): CLIP / SigLIP contrastive, DINO and iBOT
(through the fused cross-entropy, ``ops/fused_ce.py``), the weighted
center update, pixel reconstruction and KoLeo. All are functions of
tensors; the teacher side is detached by the fused CE."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vtp_tpu_torch.ops.fused_ce import fused_ce_rows


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch; features L2-normalized. The fp32
    scale promotes bf16 features to fp32, as in the JAX package."""
    logits = torch.exp(logit_scale) * image_features.float() @ text_features.float().t()
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = -F.log_softmax(logits, -1).gather(-1, labels[:, None]).mean()
    lt = -F.log_softmax(logits.t(), -1).gather(-1, labels[:, None]).mean()
    return 0.5 * (li + lt)


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor) -> torch.Tensor:
    """Pairwise sigmoid loss, used when the config carries ``init_logit_bias``."""
    logits = (torch.exp(logit_scale) * image_features.float() @ text_features.float().t()
              + logit_bias)
    n = logits.shape[0]
    labels = 2.0 * torch.eye(n, device=logits.device) - 1.0
    return -torch.mean(F.logsigmoid(labels * logits)) * n


def dino_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
              center: torch.Tensor, *, student_temp: float = 0.1,
              teacher_temp: float = 0.07) -> torch.Tensor:
    """DINO cross-entropy: centered, sharpened teacher targets against the
    student log-softmax, averaged over rows."""
    return fused_ce_rows(teacher_logits, student_logits, center.float(),
                         teacher_temp, student_temp).mean()


def ibot_loss(student_patch_logits: torch.Tensor, teacher_patch_logits: torch.Tensor,
              center: torch.Tensor, mask_weight: Optional[torch.Tensor] = None, *,
              student_temp: float = 0.1, teacher_temp: float = 0.07) -> torch.Tensor:
    """Masked-patch DINO loss on the iBOT buffer; padded rows carry weight 0."""
    per_token = fused_ce_rows(teacher_patch_logits, student_patch_logits, center.float(),
                              teacher_temp, student_temp)
    if mask_weight is None:
        return per_token.mean()
    denom = torch.clamp(mask_weight.sum(), min=1.0)
    return (per_token * mask_weight).sum() / denom


@torch.no_grad()
def update_center(center: torch.Tensor, teacher_logits: torch.Tensor, momentum: float = 0.9,
                  weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EMA center over the batch of teacher logits; ``weight`` masks the
    iBOT buffer's padded rows (an unweighted mean would pull the center
    toward token 0, the padding index)."""
    tl = teacher_logits.float()
    if weight is None:
        batch_center = tl.mean(0)
    else:
        w = weight.float()
        batch_center = (tl * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1.0)
    return momentum * center + (1.0 - momentum) * batch_center


def reconstruction_loss(reconstructed: torch.Tensor, target: torch.Tensor, *,
                        loss_type: str = "mse") -> torch.Tensor:
    diff = reconstructed.float() - target.float()
    if loss_type == "mse":
        return torch.mean(diff * diff)
    if loss_type == "l1":
        return torch.mean(diff.abs())
    if loss_type == "smooth_l1":
        a = diff.abs()
        return torch.mean(torch.where(a < 1.0, 0.5 * diff * diff, a - 0.5))
    raise ValueError(loss_type)


def koleo_loss(features: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """KoLeo regularizer (DINOv2): -mean log nearest-neighbour distance of
    the L2-normalized cls features within the batch."""
    f = features / torch.clamp(torch.linalg.vector_norm(features, dim=-1, keepdim=True), min=eps)
    sim = f @ f.t()
    sim = sim - 2.0 * torch.eye(f.shape[0], device=f.device, dtype=sim.dtype)
    nn_sim = sim.amax(-1)
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * nn_sim, min=eps))
    return -torch.mean(torch.log(dist + eps))
