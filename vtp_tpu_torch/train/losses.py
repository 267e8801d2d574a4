"""Training objectives of the VTP meta-architecture (port of
``vtp_tpu/train/losses.py``): CLIP / SigLIP contrastive, DINO and iBOT
(through the fused cross-entropy, ``ops/fused_ce.py``), the weighted
center update, pixel reconstruction and KoLeo. All are functions of
tensors; the teacher side is detached by the fused CE.

Under data parallelism (``data``, the mesh's data axis) each rank holds its
rows and the JAX package's reductions over the global batch become this
rank's share of them: the contrastive and KoLeo losses gather the other
ranks' features (``gather_with_grad``) and score this rank's rows against
all of them, and each loss is divided by the global row count, so that
the ranks' losses sum to the global one and their gradients, summed over
the data axis, to its gradient."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vtp_tpu_torch.ops.fused_ce import fused_ce_rows
from vtp_tpu_torch.parallel.mesh import AxisGroup
from vtp_tpu_torch.parallel.sharding import gather_with_grad


def _global(x: torch.Tensor, data: Optional[AxisGroup]) -> torch.Tensor:
    """``x``'s rows from every rank of ``data`` (with gradient); ``x`` without."""
    return x if data is None else gather_with_grad(x, data)


def _own_rows(b: int, data: Optional[AxisGroup], device) -> torch.Tensor:
    """This rank's ``b`` rows' indices in the global batch."""
    return (0 if data is None else data.rank * b) + torch.arange(b, device=device)


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, data: Optional[AxisGroup] = None) -> torch.Tensor:
    """Symmetric InfoNCE over the batch; features L2-normalized. The fp32
    scale promotes bf16 features to fp32, as in the JAX package. With
    ``data``, this rank's share of the loss over the global batch."""
    img, txt = image_features.float(), text_features.float()
    img_all, txt_all = _global(img, data), _global(txt, data)
    scale = torch.exp(logit_scale)
    labels = _own_rows(img.shape[0], data, img.device)[:, None]
    li = -F.log_softmax(scale * img @ txt_all.t(), -1).gather(-1, labels).sum()
    lt = -F.log_softmax(scale * txt @ img_all.t(), -1).gather(-1, labels).sum()
    return 0.5 * (li + lt) / img_all.shape[0]


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                data: Optional[AxisGroup] = None) -> torch.Tensor:
    """Pairwise sigmoid loss, used when the config carries ``init_logit_bias``.
    With ``data``, this rank's rows of the global logits."""
    txt = _global(text_features.float(), data)
    logits = torch.exp(logit_scale) * image_features.float() @ txt.t() + logit_bias
    b, n = logits.shape
    labels = 2.0 * (torch.arange(n, device=logits.device)[None, :]
                    == _own_rows(b, data, logits.device)[:, None]).float() - 1.0
    return -F.logsigmoid(labels * logits).sum() / n


def dino_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
              center: torch.Tensor, *, student_temp: float = 0.1,
              teacher_temp: float = 0.07) -> torch.Tensor:
    """DINO cross-entropy: centered, sharpened teacher targets against the
    student log-softmax, averaged over rows."""
    return fused_ce_rows(teacher_logits, student_logits, center.float(),
                         teacher_temp, student_temp).mean()


def ibot_loss(student_patch_logits: torch.Tensor, teacher_patch_logits: torch.Tensor,
              center: torch.Tensor, mask_weight: Optional[torch.Tensor] = None, *,
              student_temp: float = 0.1, teacher_temp: float = 0.07,
              weight_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-patch DINO loss on the iBOT buffer; padded rows carry weight 0.
    ``weight_sum``: the global batch's sum of ``mask_weight`` (a data
    shard's share of the loss); this buffer's own sum when not given."""
    per_token = fused_ce_rows(teacher_patch_logits, student_patch_logits, center.float(),
                              teacher_temp, student_temp)
    if mask_weight is None:
        return per_token.mean()
    denom = torch.clamp(mask_weight.sum() if weight_sum is None else weight_sum, min=1.0)
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


def koleo_loss(features: torch.Tensor, eps: float = 1e-8,
               data: Optional[AxisGroup] = None) -> torch.Tensor:
    """KoLeo regularizer (DINOv2): -mean log nearest-neighbour distance of
    the L2-normalized cls features within the batch. With ``data``, this
    rank's rows' share, their neighbours searched over the global batch."""
    f = features / torch.clamp(torch.linalg.vector_norm(features, dim=-1, keepdim=True), min=eps)
    f_all = _global(f, data)
    sim = f @ f_all.t()
    own = _own_rows(f.shape[0], data, f.device)
    sim = sim - 2.0 * (torch.arange(f_all.shape[0], device=f.device)[None, :]
                       == own[:, None]).to(sim.dtype)
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * sim.amax(-1), min=eps))
    return -torch.log(dist + eps).sum() / f_all.shape[0]
