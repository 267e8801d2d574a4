"""The VTP training step: CLIP + DINOv2-style SSL + reconstruction (port of
``vtp_tpu/train/step.py``: ``TrainConfig`` :58, ``make_optimizer`` :160,
``init_state`` :208, ``make_ssl_batch`` :216, ``build_train_step`` :263).

One step runs the CLIP branch (image and text towers, contrastive loss),
the reconstruction branch (bf16 trunk + pixel decoder, pixel loss) and the
SSL branch (a no-grad EMA teacher on the global crops with the crop swap;
the student on the masked globals and the local crops; DINO heads; DINO,
iBOT and KoLeo losses), then one backward, clip by global norm, AdamW,
the teacher EMA and both center updates. The state is updated in place.

Ported: ``accum_steps == 1``, drop rates 0, every ``remat`` policy of the
JAX package's ``remat_wrap`` (``models/blocks.py`` ``checkpoint_policy``),
fp32 or bf16 Adam moments, bf16 or fp32 compute. Each of gradient
accumulation, drop-path, the RoPE coordinate augmentation, sequence and
pipeline parallelism and the head-major TP layout raises
``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.models.dino_head import DinoHead, DinoHeadConfig
from vtp_tpu_torch.models.vtp_model import VTPModel, l2_normalize
from vtp_tpu_torch.ops.patchify import patch_tokens_to_4d
from vtp_tpu_torch.train.losses import (
    clip_loss,
    dino_loss,
    ibot_loss,
    koleo_loss,
    reconstruction_loss,
    siglip_loss,
    update_center,
)
from vtp_tpu_torch.train.optim import AdamW
from vtp_tpu_torch.train.state import (
    TrainState,
    ema_update,
    make_teacher,
    student_parts,
    train_leaves,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """A copy of the JAX package's ``TrainConfig`` (same fields and
    defaults); the options the port does not run raise in
    ``check_supported``."""

    train_clip: bool = True
    train_ssl: bool = True
    train_reconstruction: bool = True
    clip_weight: float = 1.0
    dino_weight: float = 1.0
    ibot_weight: float = 1.0
    koleo_weight: float = 0.1
    rec_weight: float = 1.0
    rec_loss_type: str = "mse"
    clip_drop_rate: float = 0.0
    ssl_drop_rate: float = 0.0
    rec_drop_rate: float = 0.0
    dino_out_dim: int = 65536
    dino_hidden_dim: int = 2048
    dino_bottleneck_dim: int = 256
    dino_nlayers: int = 3
    student_temp: float = 0.1
    teacher_temp: float = 0.07
    center_momentum: float = 0.9
    teacher_momentum: float = 0.994
    n_global_crops: int = 2
    learning_rate: float = 1e-3
    weight_decay: float = 0.04
    beta1: float = 0.9
    beta2: float = 0.95
    warmup_steps: int = 1000
    total_steps: int = 100_000
    grad_clip: float = 1.0
    zero_safe_normalize: bool = True
    compute_dtype: Optional[str] = "bf16"
    remat: Union[bool, str] = True
    unroll_layers: Union[bool, int] = False  # the port's depth loop is always a Python loop
    drop_shards: int = 1
    sequence_parallel: bool = False
    pipeline_stages: int = 1
    tp_head_major: int = 1
    accum_steps: int = 1
    moment_dtype: str = "fp32"
    accum_dtype: str = "fp32"

    @property
    def torch_compute_dtype(self) -> Optional[torch.dtype]:
        return {None: None, "bf16": torch.bfloat16, "fp32": None}[self.compute_dtype]


def check_supported(cfg: VTPConfig, tcfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for every option the port does not run."""
    unported = {
        "accum_steps > 1 (gradient accumulation)": tcfg.accum_steps > 1,
        "drop-path (clip/ssl/rec drop rates > 0)":
            max(tcfg.clip_drop_rate, tcfg.ssl_drop_rate, tcfg.rec_drop_rate) > 0,
        "sequence_parallel": tcfg.sequence_parallel,
        "pipeline_stages > 1": tcfg.pipeline_stages > 1,
        "tp_head_major > 1": tcfg.tp_head_major > 1,
        "vision_qkv_head_major > 1 (training a head-major model)": cfg.vision_qkv_head_major > 1,
        "drop_shards > 1": tcfg.drop_shards > 1,
        "RoPE coordinate augmentation (rope_shift/jitter/rescale_coords)": any(
            v is not None for v in (cfg.rope_shift_coords, cfg.rope_jitter_coords,
                                    cfg.rope_rescale_coords)),
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(f"not ported: {', '.join(asked)}")


def dino_head_config(cfg: VTPConfig, tcfg: TrainConfig) -> DinoHeadConfig:
    in_dim = cfg.vision_embed_dim if cfg.vision_bottleneck_ae_only else cfg.vision_feature_bottleneck
    return DinoHeadConfig(in_dim=in_dim, out_dim=tcfg.dino_out_dim, nlayers=tcfg.dino_nlayers,
                          hidden_dim=tcfg.dino_hidden_dim, bottleneck_dim=tcfg.dino_bottleneck_dim)


def make_optimizer(leaves: Dict[str, torch.Tensor], tcfg: TrainConfig) -> AdamW:
    return AdamW(leaves, learning_rate=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
                 total_steps=tcfg.total_steps, weight_decay=tcfg.weight_decay, b1=tcfg.beta1,
                 b2=tcfg.beta2, grad_clip=tcfg.grad_clip, moment_dtype=tcfg.moment_dtype)


def init_state(cfg: VTPConfig, tcfg: TrainConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> TrainState:
    """Random student weights drawn from ``generator`` (on ``device``,
    seeded with 0 when not given), a teacher copied from them, zero
    moments and zero centers."""
    check_supported(cfg, tcfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = VTPModel.init(cfg, generator, device=device)
    head = None
    if tcfg.train_ssl:
        with torch.device("meta"):
            head = DinoHead(dino_head_config(cfg, tcfg))
        head.to_empty(device=device)
        head.reset_parameters(generator)
    optimizer = make_optimizer(train_leaves(model, head), tcfg)
    teacher = centers = None
    if head is not None:
        teacher = make_teacher(model, head)
        centers = [torch.zeros(tcfg.dino_out_dim, device=device) for _ in range(2)]
    return TrainState(model, head, optimizer, teacher, *(centers or (None, None)))


def make_ssl_batch(generator: torch.Generator, batch: int, *, global_size: int = 256,
                   local_size: int = 96, n_local: int = 4, patch: int = 16,
                   mask_ratio: float = 0.3, upperbound_ratio: float = 0.5,
                   device=None) -> Dict[str, torch.Tensor]:
    """Synthetic multi-crop SSL batch with the iBOT mask bookkeeping in the
    reference's static-``upperbound`` layout: ``mask_indices`` padded with
    index 0 at weight 0 up to the upperbound."""
    device = device if device is not None else generator.device
    n_patches = (global_size // patch) ** 2
    n_tokens = 2 * batch * n_patches
    upperbound = int(n_tokens * upperbound_ratio)
    n_masked = int(n_tokens * mask_ratio)
    kw = dict(generator=generator, device=device)
    global_crops = torch.randn((2 * batch, 3, global_size, global_size), **kw)
    local_crops = torch.randn((n_local * batch, 3, local_size, local_size), **kw)
    perm = torch.randperm(n_tokens, **kw)
    mask_indices = torch.zeros(upperbound, dtype=torch.long, device=device)
    mask_indices[:n_masked] = perm[:n_masked]
    mask_weight = (torch.arange(upperbound, device=device) < n_masked).float()
    masks = torch.zeros(n_tokens, dtype=torch.bool, device=device)
    masks[perm[:n_masked]] = True
    return {"global_crops": global_crops, "local_crops": local_crops,
            "masks": masks.reshape(2 * batch, n_patches), "mask_indices": mask_indices,
            "mask_weight": mask_weight}


def build_train_step(cfg: VTPConfig, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    updates ``state`` in place.

    batch keys (each objective runs when its keys are present):
      image (B,3,H,W), text (B,L): the CLIP pair
      rec_image (B,3,H,W): the reconstruction target
      ssl: a dict as ``make_ssl_batch`` returns
    metrics: 0-dim tensors ``loss/{clip,rec,dino,ibot,koleo,total}`` and
    ``grad_norm`` (before clipping)."""
    check_supported(cfg, tcfg)
    cdt = tcfg.torch_compute_dtype
    remat = tcfg.remat
    use_bn_for_ssl = not cfg.vision_bottleneck_ae_only
    p = cfg.vision_patch_size

    def clip_branch(model: VTPModel, image, text):
        img = l2_normalize(model.clip_image_embedding(image, cdt, training=True, remat=remat))
        t_out = model.text(text, compute_dtype=cdt, remat=remat)
        txt = l2_normalize(t_out[0] if isinstance(t_out, tuple) else t_out)
        if model.logit_bias is not None:
            return siglip_loss(img, txt, model.logit_scale, model.logit_bias)
        return clip_loss(img, txt, model.logit_scale)

    def rec_branch(model: VTPModel, image):
        _, _, H, W = image.shape
        out = model.trunk.forward_features(image, use_bottleneck=True, compute_dtype=cdt,
                                           training=True, remat=remat)
        latents = patch_tokens_to_4d(out["x_norm_patchtokens"], H // p, W // p)
        rec = model.pixel_decoder(latents, compute_dtype=cdt, remat=remat)
        return reconstruction_loss(rec, image, loss_type=tcfg.rec_loss_type)

    def ssl_branch(state: TrainState, ssl):
        teacher = state.teacher
        g = ssl["global_crops"]
        bc = g.shape[0] // tcfg.n_global_crops
        with torch.no_grad():
            t_out = teacher["trunk"].forward_features(g, use_bottleneck=use_bn_for_ssl,
                                                      compute_dtype=cdt)
            t_cls = t_out["x_norm_clstoken"]
            # crop swap: student crop i targets the teacher of the other crop
            t_cls_head = teacher["dino_head"](torch.cat([t_cls[bc:], t_cls[:bc]]),
                                              compute_dtype=cdt)
            t_patch = t_out["x_norm_patchtokens"]
            t_masked = t_patch.reshape(-1, t_patch.shape[-1])[ssl["mask_indices"]]
            t_masked_head = teacher["dino_head"](t_masked, compute_dtype=cdt)

        s_global, s_local = state.model.trunk.forward_features(
            [g, ssl["local_crops"]], masks=[ssl["masks"], None], use_bottleneck=use_bn_for_ssl,
            compute_dtype=cdt, training=True, remat=remat)
        s_g_cls, s_l_cls = s_global["x_norm_clstoken"], s_local["x_norm_clstoken"]

        def head(x):
            return state.dino_head(x, compute_dtype=cdt,
                                   zero_safe_normalize=tcfg.zero_safe_normalize)

        s_g_head, s_l_head = head(s_g_cls), head(s_l_cls)
        s_patch = s_global["x_norm_patchtokens"].reshape(-1, s_g_cls.shape[-1])
        s_masked_head = head(s_patch[ssl["mask_indices"]])
        temps = dict(student_temp=tcfg.student_temp, teacher_temp=tcfg.teacher_temp)
        l_dino_g = dino_loss(s_g_head, t_cls_head, state.dino_center, **temps)
        # the locals target t_cls_head[:bc], tiled: after the crop swap that is
        # the teacher on the second global crop (as the JAX step computes it)
        n_local = s_l_head.shape[0] // bc
        l_dino_l = dino_loss(s_l_head, t_cls_head[:bc].repeat(n_local, 1), state.dino_center,
                             **temps)
        l_ibot = ibot_loss(s_masked_head, t_masked_head, state.ibot_center, ssl["mask_weight"],
                           **temps)
        l_koleo = koleo_loss(s_g_cls)
        return l_dino_g + l_dino_l, l_ibot, l_koleo, (t_cls_head, t_masked_head)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        metrics: Dict[str, torch.Tensor] = {}
        total = 0.0
        aux = None
        if tcfg.train_clip and "image" in batch:
            loss = clip_branch(model, batch["image"], batch["text"])
            metrics["loss/clip"] = loss
            total = total + tcfg.clip_weight * loss
        if tcfg.train_reconstruction and "rec_image" in batch:
            loss = rec_branch(model, batch["rec_image"])
            metrics["loss/rec"] = loss
            total = total + tcfg.rec_weight * loss
        if tcfg.train_ssl and "ssl" in batch:
            l_dino, l_ibot, l_koleo, aux = ssl_branch(state, batch["ssl"])
            metrics.update({"loss/dino": l_dino, "loss/ibot": l_ibot, "loss/koleo": l_koleo})
            total = (total + tcfg.dino_weight * l_dino + tcfg.ibot_weight * l_ibot
                     + tcfg.koleo_weight * l_koleo)
        metrics["loss/total"] = total

        leaves = state.optimizer.leaves
        names = [n for n, t in leaves.items() if t.requires_grad]
        grads = torch.autograd.grad(total, [leaves[n] for n in names], allow_unused=True)
        metrics["grad_norm"] = state.optimizer.step(dict(zip(names, grads)))
        del grads
        state.step += 1
        if state.teacher is not None:
            ema_update(state.teacher, student_parts(state.model, state.dino_head),
                       tcfg.teacher_momentum)
            if aux is not None:
                t_cls_head, t_masked_head = aux
                state.dino_center = update_center(state.dino_center, t_cls_head,
                                                  tcfg.center_momentum)
                state.ibot_center = update_center(state.ibot_center, t_masked_head,
                                                  tcfg.center_momentum,
                                                  weight=batch["ssl"]["mask_weight"])
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
