"""The VTP training step: CLIP + DINOv2-style SSL + reconstruction (port of
``vtp_tpu/train/step.py``: ``TrainConfig`` :58, ``make_optimizer`` :160,
``init_state`` :208, ``make_ssl_batch`` :216, ``build_train_step`` :263,
its accumulation :474-598, ``objective_grad_norms`` :600,
``run_host_accum_step`` :639).

One step runs the CLIP branch (image and text towers, contrastive loss),
the reconstruction branch (bf16 trunk + pixel decoder, pixel loss) and the
SSL branch (a no-grad EMA teacher on the global crops with the crop swap;
the student on the masked globals and the local crops; DINO heads; DINO,
iBOT and KoLeo losses), then one backward, clip by global norm, AdamW,
the teacher EMA and both center updates. The state is updated in place.

Where the JAX step takes a key, this one takes a ``generator`` or
``draws``: each trained trunk forward's RoPE coordinate augmentation and
drop-path rows (``VisionTransformer.sample_draws``), per branch
(``clip``, ``rec``, ``ssl``, as JAX splits its key). ``sample_draws``
draws a whole step's before its first forward, so a checkpointed block
recomputes with the rows it ran with. A test gives the JAX package's
draws instead.

With ``accum_steps > 1`` every batch leaf carries a leading (accum,)
microbatch axis and the step is the host-driven accumulation
(``micro_step``, ``zero_accumulators``, ``apply_accum``; ``run_host_accum_step``):
the gradient sums add in fp32 and are stored in ``accum_dtype``, grads and
metrics are averaged over the microbatches before the one update, and the
centers move by statistics pooled over them. In fp32 this equals the JAX
package's in-jit scan bit for bit (its sums start from the first
microbatch's gradients; 0 + g = g).

``build_train_step(cfg, tcfg, mesh)`` runs the step over a ``(data, model)``
DeviceMesh (``parallel.mesh.make_mesh``) on a state that ``init_state(...,
mesh=mesh)`` or ``distribute_state`` spread over it; every rank passes the
same global batch and generator (or draws), as the JAX step takes global
arrays. The semantics are the JAX step's under GSPMD:

  * data parallelism: each rank takes its rows (``shard_train_batch``; the
    SSL crops by image, the iBOT indices re-based), every loss is the
    rank's share of the global-batch loss (``train/losses.py``), the
    gradients are summed over ``data`` in one explicit collective after
    accumulation (the step differentiates with ``torch.autograd.grad``, so
    no DDP or FSDP2 hook would run), the center statistics and the metrics
    are summed too; drop-path draws its subsets over the global batch with
    ``drop_shards``' keep counts and each rank runs the kept rows in its shard;
  * tensor (and sequence) parallelism: the towers hold their slabs
    (``parallel.sharding.parallelize_model``), ``tp_head_major`` stores the
    trunk head-major (it must equal the model axis);
  * FSDP (ZeRO-3): on a state that ``parallel.fsdp.shard_state`` sharded,
    the parameters, the teacher and the moments are slabs; each forward
    reads a parameter whole through its all-gather, whose backward
    reduce-scatters the gradient to the slab, and AdamW and the EMA run on
    the slabs.

Over a ``(data, seq[, model])`` mesh (``parallel.mesh.make_cp_mesh``;
``init_state``'s and ``distribute_state``'s ``cp_mode`` picks the arm)
the trunk and the pixel decoder split each crop's tokens over ``seq``
through their block stacks (context parallelism, ``models/blocks.run_blocks``).
Their blocks' parameters get a partial gradient on each seq rank, from its
tokens, and those are summed over ``seq``; every other gradient is already
whole and equal on the seq ranks (``split_seq`` gathers the gradient of the
stack's input, ``unsplit_seq`` hands each rank its rows of the output's).
Over a ``(data, pipe)`` mesh (``make_pp_mesh``) their no-drop-path stacks
are pipelined (``parallel/pipeline.py``), whose backward hands every rank
every layer's gradient, so nothing more is summed. The state stays
replicated over ``seq`` and ``pipe``, as in the JAX package, and the text
tower runs whole on every rank.

The grad norm is global: sharded leaves sum their squares over their axes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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
from vtp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    axis_group,
    mesh_axis_size,
)
from vtp_tpu_torch.parallel.fsdp import saved_whole_tensors
from vtp_tpu_torch.parallel.sharding import all_reduce_, parallelize_model, shard_batch
from vtp_tpu_torch.train.optim import (
    ACCUM_DTYPES,
    AdamW,
    accumulate_grads,
    all_reduce_flat,
    global_norm_sq,
)
from vtp_tpu_torch.train.state import (
    TrainState,
    ema_update,
    make_teacher,
    student_parts,
    train_leaves,
)


BRANCH_DROP = {"clip": "clip_drop_rate", "rec": "rec_drop_rate", "ssl": "ssl_drop_rate"}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """A copy of the JAX package's ``TrainConfig`` (same fields and
    defaults). ``pipeline_stages`` is the pipe axis the step is built for
    (``tools/train_vtp.py --pipeline_parallel`` builds its mesh from it): on
    a mesh it must be 1 or the mesh's pipe axis (``check_supported``), and
    the mesh decides, as the JAX package's ambient mesh does; without a
    mesh the stacks run their sequential loop."""

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


def check_supported(cfg: VTPConfig, tcfg: TrainConfig, mesh=None) -> None:
    """Raise ``ValueError`` for an unknown ``accum_dtype``, for
    ``pipeline_stages`` other than 1 or the mesh's pipe axis, and for the
    JAX step's head-major checks (:272-282): ``tp_head_major`` must divide
    the trunk's heads, agree with the config's declared layout and, on a
    mesh, equal its model axis."""
    pipe = mesh_axis_size(mesh, PIPE_AXIS)
    if mesh is not None and tcfg.pipeline_stages not in (1, pipe):
        raise ValueError(f"pipeline_stages={tcfg.pipeline_stages} must equal the mesh's pipe "
                         f"axis ({pipe})")
    if tcfg.accum_dtype not in ACCUM_DTYPES:
        raise ValueError(f"unknown accum_dtype {tcfg.accum_dtype!r} (use 'fp32' or 'bf16')")
    hm = tcfg.tp_head_major
    if hm > 1:
        if cfg.vision_num_heads % hm:
            raise ValueError(f"tp_head_major={hm} must divide vision_num_heads="
                             f"{cfg.vision_num_heads}")
        if cfg.vision_qkv_head_major not in (1, hm):
            raise ValueError(f"tp_head_major={hm} conflicts with the model config's declared "
                             f"layout vision_qkv_head_major={cfg.vision_qkv_head_major}")
        if mesh is not None and mesh_axis_size(mesh, MODEL_AXIS) != hm:
            raise ValueError(f"tp_head_major={hm} must equal the mesh's model axis "
                             f"({mesh_axis_size(mesh, MODEL_AXIS)})")


def train_model_config(cfg: VTPConfig, tcfg: TrainConfig) -> VTPConfig:
    """The config of the trained model: ``tp_head_major`` stores a canonical
    trunk head-major (JAX ``init_train_params`` :182-189)."""
    if tcfg.tp_head_major > 1 and cfg.vision_qkv_head_major == 1:
        return cfg.replace(vision_qkv_head_major=tcfg.tp_head_major)
    return cfg


def dino_head_config(cfg: VTPConfig, tcfg: TrainConfig) -> DinoHeadConfig:
    in_dim = cfg.vision_embed_dim if cfg.vision_bottleneck_ae_only else cfg.vision_feature_bottleneck
    return DinoHeadConfig(in_dim=in_dim, out_dim=tcfg.dino_out_dim, nlayers=tcfg.dino_nlayers,
                          hidden_dim=tcfg.dino_hidden_dim, bottleneck_dim=tcfg.dino_bottleneck_dim)


def make_optimizer(leaves: Dict[str, torch.Tensor], tcfg: TrainConfig) -> AdamW:
    return AdamW(leaves, learning_rate=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
                 total_steps=tcfg.total_steps, weight_decay=tcfg.weight_decay, b1=tcfg.beta1,
                 b2=tcfg.beta2, grad_clip=tcfg.grad_clip, moment_dtype=tcfg.moment_dtype)


def init_train_modules(cfg: VTPConfig, tcfg: TrainConfig,
                       generator: Optional[torch.Generator] = None, device="cuda"
                       ) -> Tuple[VTPModel, Optional[DinoHead]]:
    """Random student weights drawn from ``generator`` (on ``device``,
    seeded with 0 when not given): the model and, with ``train_ssl``, the
    DINO head (JAX ``init_train_params`` :185)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = VTPModel.init(cfg, generator, device=device)
    head = None
    if tcfg.train_ssl:
        with torch.device("meta"):
            head = DinoHead(dino_head_config(cfg, tcfg))
        head.to_empty(device=device)
        head.reset_parameters(generator)
    return model, head


def init_state(cfg: VTPConfig, tcfg: TrainConfig, generator: Optional[torch.Generator] = None,
               device="cuda", mesh=None, cp_mode: str = "auto") -> TrainState:
    """``init_train_modules``' student (its trunk head-major under
    ``tp_head_major``, permuted from the same canonical init), a teacher
    copied from it, zero moments and zero centers; spread over ``mesh``
    (``distribute_state``, with ``cp_mode``) when one is given. Every rank
    draws the same weights from the same seed."""
    check_supported(cfg, tcfg, mesh)
    model, head = init_train_modules(train_model_config(cfg, tcfg), tcfg, generator, device)
    optimizer = make_optimizer(train_leaves(model, head), tcfg)
    teacher = centers = None
    if head is not None:
        teacher = make_teacher(model, head)
        centers = [torch.zeros(tcfg.dino_out_dim, device=device) for _ in range(2)]
    state = TrainState(model, head, optimizer, teacher, *(centers or (None, None)))
    return state if mesh is None else distribute_state(state, tcfg, mesh, cp_mode)


def distribute_state(state: TrainState, tcfg: TrainConfig, mesh,
                     cp_mode: str = "auto") -> TrainState:
    """Spread a whole (one-process) train state over ``mesh`` in place: the
    student and the teacher tensor-parallelized over its model axis (at any
    size, 1 included), the optimizer rebuilt over the student's slabs with
    its moments sliced alike; over a seq or pipe axis their trunks and pixel
    decoders set to split their tokens (arm ``cp_mode``) or pipeline their
    stacks (``parallel.sharding.parallelize_model``). Data parallelism needs
    nothing of the state; FSDP is ``parallel.fsdp.shard_state`` after this.
    Returns the state."""
    check_supported(state.model.config, tcfg, mesh)
    extra = [state.teacher] if state.teacher is not None else []
    parallelize_model(state.model, mesh, head_major=tcfg.tp_head_major > 1,
                      sequence_parallel=tcfg.sequence_parallel, also=extra, cp_mode=cp_mode)
    layout = state.model.shard_layout
    old = state.optimizer
    opt = make_optimizer(train_leaves(state.model, state.dino_head), tcfg)
    with torch.no_grad():
        for moments, src in ((opt.mu, old.mu), (opt.nu, old.nu)):
            for n, m in moments.items():
                full = src[n]
                m.copy_(layout.slab(n, full) if layout.is_sharded(n, full.ndim) else full)
    opt.count = old.count
    state.optimizer = opt
    state.layout = layout
    return state


def _shard_rows(x: torch.Tensor, data, images: int) -> torch.Tensor:
    """A crop tensor of ``views`` x ``images`` rows (view-major, as the SSL
    crops are laid out) -> this data shard's images of every view."""
    b = images // data.size
    views = x.shape[0] // images
    lo = data.rank * b
    return x.reshape(views, images, *x.shape[1:])[:, lo:lo + b].reshape(views * b, *x.shape[1:])


def _local_rows(idx: torch.Tensor, data, images: int) -> torch.Tensor:
    """Rows ``idx`` of a view-major crop tensor of ``images`` images -> the
    ones of this data shard's images, as rows of its ``_shard_rows``."""
    b = images // data.size
    view, img = idx // images, idx % images
    keep = (img >= data.rank * b) & (img < (data.rank + 1) * b)
    return (view * b + img - data.rank * b)[keep]


def shard_train_batch(batch: Dict[str, Any], mesh, n_global_crops: int = 2) -> Dict[str, Any]:
    """This data shard's part of a global batch (one microbatch): the rows
    of ``image``, ``text`` and ``rec_image``; of ``ssl``, every crop of its
    images (``global_crops`` / ``masks`` / ``local_crops`` are view-major)
    and the iBOT entries that fall on them, their token indices re-based."""
    data = axis_group(mesh, DATA_AXIS)
    out = {}
    for k, v in batch.items():
        if k != "ssl":
            out[k] = shard_batch(v, mesh)
            continue
        images = v["global_crops"].shape[0] // n_global_crops
        if images % data.size:
            raise ValueError(f"ssl: {images} images do not divide over the data axis "
                             f"({data.size} shards)")
        n_patches = v["masks"].shape[1]
        row, patch = v["mask_indices"] // n_patches, v["mask_indices"] % n_patches
        b = images // data.size
        keep = (row % images) // b == data.rank
        out[k] = {"global_crops": _shard_rows(v["global_crops"], data, images),
                  "local_crops": _shard_rows(v["local_crops"], data, images),
                  "masks": _shard_rows(v["masks"], data, images),
                  "mask_indices": _local_rows(row, data, images) * n_patches + patch[keep],
                  "mask_weight": v["mask_weight"][keep]}
    return out


def shard_draws(draws: Dict[str, Dict[str, list]], batch: Dict[str, Any], data,
                n_global_crops: int = 2) -> Dict[str, Dict[str, list]]:
    """A global batch's draws (one microbatch) -> this data shard's: the
    RoPE factors as they are; each drop-path subset cut to the shard's rows
    (``_local_rows``), with ``drop_scale``, the global subset's b / keep."""
    out = {}
    for name, d in draws.items():
        if "drop" not in d:
            out[name] = d
            continue
        if name == "ssl":
            crops = [batch["ssl"]["global_crops"], batch["ssl"]["local_crops"]]
            images = crops[0].shape[0] // n_global_crops
        else:
            crops = [batch["image" if name == "clip" else "rec_image"]]
            images = crops[0].shape[0]
        rows = [c.shape[0] for c in crops] * 2
        out[name] = dict(d, drop=[[_local_rows(ix, data, images) for ix in layer]
                                  for layer in d["drop"]],
                         drop_scale=[[r / ix.numel() for r, ix in zip(rows, layer)]
                                     for layer in d["drop"]])
    return out


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


def _center_stats(aux, ssl) -> Tuple[torch.Tensor, ...]:
    """The center EMAs' sufficient statistics of one microbatch (JAX
    :436): the sum of the teacher cls logits, their row count, the
    weighted sum of the teacher masked logits and the weight sum."""
    t_cls_head, t_masked_head = aux
    w = ssl["mask_weight"].float()
    return (t_cls_head.float().sum(0),
            torch.tensor(float(t_cls_head.shape[0]), device=t_cls_head.device),
            (t_masked_head.float() * w[:, None]).sum(0), w.sum())


def _micro(batch: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _micro(v, i) if isinstance(v, dict) else v[i] for k, v in batch.items()}


def build_train_step(cfg: VTPConfig, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(state, batch, generator=None, draws=None) ->
    (state, metrics)``, which updates ``state`` in place; over ``mesh``
    (every rank passing the same global batch) when one is given.

    batch keys (each objective runs when its keys are present), with a
    leading (accum_steps,) axis on every leaf when ``accum_steps > 1``:
      image (B,3,H,W), text (B,L): the CLIP pair
      rec_image (B,3,H,W): the reconstruction target
      ssl: a dict as ``make_ssl_batch`` returns
    ``draws``: ``train_step.sample_draws``'s (a list of one per microbatch
    when accumulating), drawn from ``generator`` when not given; a step that
    augments the RoPE coordinates or drops paths needs one of them.
    metrics: 0-dim tensors ``loss/{clip,rec,dino,ibot,koleo,total}`` and
    ``grad_norm`` (before clipping, after averaging the microbatches).

    Attributes: ``sample_draws(generator, batch)``, ``micro_step``,
    ``zero_accumulators``, ``apply_accum`` and ``objective_grad_norms``."""
    check_supported(cfg, tcfg, mesh)
    data = axis_group(mesh, DATA_AXIS)
    model_axis = axis_group(mesh, MODEL_AXIS)
    seq = axis_group(mesh, SEQ_AXIS)
    cdt = tcfg.torch_compute_dtype
    remat = tcfg.remat
    use_bn_for_ssl = not cfg.vision_bottleneck_ae_only
    p = cfg.vision_patch_size
    accum = max(1, int(tcfg.accum_steps))
    adt = ACCUM_DTYPES[tcfg.accum_dtype]
    random = (max(tcfg.clip_drop_rate, tcfg.ssl_drop_rate, tcfg.rec_drop_rate) > 0
              or any(v is not None for v in (cfg.rope_shift_coords, cfg.rope_jitter_coords,
                                             cfg.rope_rescale_coords)))

    def trunk_kw(branch: str, draws) -> Dict[str, Any]:
        return dict(training=True, remat=remat, drop_ratio=getattr(tcfg, BRANCH_DROP[branch]),
                    draws=draws)

    def branches(batch) -> List[str]:
        out = []
        if tcfg.train_clip and "image" in batch:
            out.append("clip")
        if tcfg.train_reconstruction and "rec_image" in batch:
            out.append("rec")
        if tcfg.train_ssl and "ssl" in batch:
            out.append("ssl")
        return out

    def sample_draws(state: TrainState, generator: torch.Generator,
                     batch: Dict[str, Any]) -> Dict[str, Dict[str, list]]:
        """One microbatch's draws (no accum axis), per branch that runs, in
        the order clip, rec, ssl."""
        trunk = state.model.trunk
        out = {}
        for name in branches(batch):
            if name == "ssl":
                crops = [batch["ssl"]["global_crops"], batch["ssl"]["local_crops"]]
            else:
                crops = [batch["image" if name == "clip" else "rec_image"]]
            out[name] = trunk.sample_draws(generator, [c.shape[0] for c in crops],
                                           getattr(tcfg, BRANCH_DROP[name]), tcfg.drop_shards)
        return out

    def resolve_draws(state, batch, generator, draws):
        if draws is not None or not random:
            return draws or {}
        if generator is None:
            raise ValueError("this step augments the RoPE coordinates or drops paths: "
                             "pass a generator or draws")
        return sample_draws(state, generator, batch)

    def share(loss):
        """A data shard's mean -> its share of the global-batch mean."""
        return loss if data is None else loss / data.size

    def clip_branch(model: VTPModel, image, text, draws):
        img = l2_normalize(model.clip_image_embedding(image, cdt, **trunk_kw("clip", draws)))
        t_out = model.text(text, compute_dtype=cdt, remat=remat)
        txt = l2_normalize(t_out[0] if isinstance(t_out, tuple) else t_out)
        if model.logit_bias is not None:
            return siglip_loss(img, txt, model.logit_scale, model.logit_bias, data=data)
        return clip_loss(img, txt, model.logit_scale, data=data)

    def rec_branch(model: VTPModel, image, draws):
        _, _, H, W = image.shape
        out = model.trunk.forward_features(image, use_bottleneck=True, compute_dtype=cdt,
                                           **trunk_kw("rec", draws))
        latents = patch_tokens_to_4d(out["x_norm_patchtokens"], H // p, W // p)
        rec = model.pixel_decoder(latents, compute_dtype=cdt, remat=remat)
        return share(reconstruction_loss(rec, image, loss_type=tcfg.rec_loss_type))

    def ssl_branch(state: TrainState, ssl, draws):
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
            compute_dtype=cdt, **trunk_kw("ssl", draws))
        s_g_cls, s_l_cls = s_global["x_norm_clstoken"], s_local["x_norm_clstoken"]

        # the student heads keep the zero-safe normalize: a sample that
        # drop-path dropped from every branch leaves its masked tokens equal
        # to the zero mask_token, whose clamped normalize has a 1/eps Jacobian
        def head(x):
            return state.dino_head(x, compute_dtype=cdt,
                                   zero_safe_normalize=tcfg.zero_safe_normalize)

        s_g_head, s_l_head = head(s_g_cls), head(s_l_cls)
        s_patch = s_global["x_norm_patchtokens"].reshape(-1, s_g_cls.shape[-1])
        s_masked_head = head(s_patch[ssl["mask_indices"]])
        temps = dict(student_temp=tcfg.student_temp, teacher_temp=tcfg.teacher_temp)
        l_dino_g = share(dino_loss(s_g_head, t_cls_head, state.dino_center, **temps))
        # the locals target t_cls_head[:bc], tiled: after the crop swap that is
        # the teacher on the second global crop (as the JAX step computes it)
        n_local = s_l_head.shape[0] // bc
        l_dino_l = share(dino_loss(s_l_head, t_cls_head[:bc].repeat(n_local, 1),
                                   state.dino_center, **temps))
        weight_sum = None
        if data is not None:
            weight_sum = all_reduce_(ssl["mask_weight"].float().sum(), data)
        l_ibot = ibot_loss(s_masked_head, t_masked_head, state.ibot_center, ssl["mask_weight"],
                           weight_sum=weight_sum, **temps)
        l_koleo = koleo_loss(s_g_cls, data=data)
        return l_dino_g + l_dino_l, l_ibot, l_koleo, (t_cls_head, t_masked_head)

    def trained(state: TrainState) -> List[str]:
        return [n for n, t in state.optimizer.leaves.items() if t.requires_grad]

    def params(state: TrainState, names: Sequence[str]) -> List[torch.Tensor]:
        """The tensors the step differentiates for trained leaves ``names``:
        the modules' own (on a ZeRO-3 state, their slabs)."""
        return [state.optimizer.leaves[n] for n in names]

    def saving(state: TrainState):
        """The context of a forward that the step differentiates: on a
        ZeRO-3 state, whole parameters are saved as their slabs."""
        if getattr(state, "fsdp", None) is None:
            return contextlib.nullcontext()
        return saved_whole_tensors()

    def localize(batch: Dict[str, Any], draws):
        """This data shard's part of a global microbatch and its draws."""
        if data is None:
            return batch, draws
        return (shard_train_batch(batch, mesh, tcfg.n_global_crops),
                shard_draws(draws, batch, data, tcfg.n_global_crops))

    def loss_and_grads(state: TrainState, batch: Dict[str, Any], draws):
        """One microbatch's gradients (by ``trained`` leaf; None where a leaf
        gets none), its detached metrics (summed over the data axis), the
        teacher heads (or None) and the SSL batch they ran on. Over a mesh,
        ``batch`` and ``draws`` are global and the gradients this rank's."""
        batch, draws = localize(batch, draws)
        with saving(state):
            metrics, total, aux = losses(state, batch, draws)
        names = trained(state)
        grads = torch.autograd.grad(total, params(state, names), allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if data is not None:
            metrics = dict(zip(metrics, all_reduce_flat(list(metrics.values()), data)))
        return list(grads), metrics, aux, batch.get("ssl")

    def losses(state: TrainState, batch: Dict[str, Any], draws):
        """The branches' losses on this rank's ``batch``: (metrics, total,
        the teacher heads or None)."""
        model = state.model
        metrics: Dict[str, torch.Tensor] = {}
        total = 0.0
        aux = None
        if tcfg.train_clip and "image" in batch:
            loss = clip_branch(model, batch["image"], batch["text"], draws.get("clip"))
            metrics["loss/clip"] = loss
            total = total + tcfg.clip_weight * loss
        if tcfg.train_reconstruction and "rec_image" in batch:
            loss = rec_branch(model, batch["rec_image"], draws.get("rec"))
            metrics["loss/rec"] = loss
            total = total + tcfg.rec_weight * loss
        if tcfg.train_ssl and "ssl" in batch:
            l_dino, l_ibot, l_koleo, aux = ssl_branch(state, batch["ssl"], draws.get("ssl"))
            metrics.update({"loss/dino": l_dino, "loss/ibot": l_ibot, "loss/koleo": l_koleo})
            total = (total + tcfg.dino_weight * l_dino + tcfg.ibot_weight * l_ibot
                     + tcfg.koleo_weight * l_koleo)
        metrics["loss/total"] = total
        return metrics, total, aux

    def sharded_over(state: TrainState) -> Dict[str, tuple]:
        """The axes each sharded trained leaf is split over (for the norm)."""
        layout = getattr(state, "layout", None)
        out = {}
        for n, t in state.optimizer.leaves.items():
            spec = layout.spec(n, t.ndim) if layout is not None else ()
            axes = tuple(g for a, g in ((MODEL_AXIS, model_axis), (DATA_AXIS, data)) if a in spec)
            if axes:
                out[n] = axes
        return out

    def seq_partial(state: TrainState, names: Sequence[str]) -> List[int]:
        """The trained leaves whose gradients are partial over ``seq``: the
        blocks of the context-parallel towers."""
        towers = [f"{n}.blocks." for n in ("trunk", "pixel_decoder")
                  if getattr(getattr(state.model, n, None), "cp", None) is not None]
        return [i for i, n in enumerate(names) if n.startswith(tuple(towers))] if towers else []

    def reduce_grads(state: TrainState, grads: Sequence[Optional[torch.Tensor]]):
        """The gradients summed over the data axis, those of context-parallel
        blocks over ``seq`` first; a leaf without one on this rank
        contributes zeros. A ZeRO-3 state's sharded gradients are already
        summed over ``data`` and cut to the slab: the backward of each whole
        read reduce-scattered them. Under accumulation that runs in every
        microbatch's backward, not once: a whole gradient lives only inside
        the backward that made it (whole-sized sums across microbatches
        would hold ZeRO-2's memory), so the sums are slab-sized."""
        names = trained(state)
        grads = [g if g is not None else torch.zeros_like(p)
                 for g, p in zip(grads, params(state, names))]
        partial = seq_partial(state, names)
        if partial:
            for i, g in zip(partial, all_reduce_flat([grads[i] for i in partial], seq)):
                grads[i] = g
        if getattr(state, "fsdp", None) is not None:
            return state.fsdp.reduce_grads(names, grads)
        return all_reduce_flat(grads, data) if data is not None else grads

    def reduce_center_stats(stats):
        return stats if data is None else tuple(all_reduce_flat(list(stats), data))

    def finish(state: TrainState, grads: Sequence[Optional[torch.Tensor]],
               metrics: Dict[str, torch.Tensor], centers) -> Tuple[TrainState, Dict]:
        """The data-axis gradient sum, the optimizer step, the teacher EMA
        and ``centers(state)``."""
        norm_sq = None
        if mesh is not None:
            grads = reduce_grads(state, grads)
            norm_sq = functools.partial(global_norm_sq, sharded_over=sharded_over(state))
        metrics["grad_norm"] = state.optimizer.step(dict(zip(trained(state), grads)), norm_sq)
        state.step += 1
        if state.teacher is not None:
            ema_update(state.teacher, student_parts(state.model, state.dino_head),
                       tcfg.teacher_momentum)
            centers(state)
        return state, metrics

    def zero_accumulators(state: TrainState, micro0: Dict[str, Any]):
        """Fresh (g_sum, m_sum, c_sum) for one microbatch's keys (no accum
        axis): gradient sums, zeros in ``accum_dtype`` by ``trained`` leaf;
        fp32 zero metric sums, their keys from the same conditions as the
        loss; the center statistics' sums (None without SSL)."""
        g_sum = [torch.zeros_like(p, dtype=adt) for p in params(state, trained(state))]
        names = {"clip": ["loss/clip"], "rec": ["loss/rec"],
                 "ssl": ["loss/dino", "loss/ibot", "loss/koleo"]}
        device = g_sum[0].device
        m_sum = {k: torch.zeros((), device=device)
                 for b in branches(micro0) for k in names[b]}
        m_sum["loss/total"] = torch.zeros((), device=device)
        c_sum = None
        if "ssl" in branches(micro0):
            d = tcfg.dino_out_dim
            c_sum = (torch.zeros(d, device=device), torch.zeros((), device=device),
                     torch.zeros(d, device=device), torch.zeros((), device=device))
        return g_sum, m_sum, c_sum

    def micro_step(state: TrainState, g_sum, m_sum, c_sum, micro: Dict[str, Any],
                   generator: Optional[torch.Generator] = None, draws=None):
        """One microbatch (no accum axis) added into the accumulators: the
        gradients in fp32, stored in their dtype; metrics and center
        statistics in fp32. Returns (g_sum, m_sum, c_sum)."""
        draws = resolve_draws(state, micro, generator, draws)
        g, m, aux, ssl = loss_and_grads(state, micro, draws)
        accumulate_grads(g_sum, g)
        del g
        m_sum = {k: m_sum[k] + m[k] for k in m_sum}
        if aux is not None:
            c_sum = tuple(a + b for a, b in zip(c_sum, _center_stats(aux, ssl)))
        return g_sum, m_sum, c_sum

    def apply_accum(state: TrainState, g_sum, m_sum, c_sum):
        """The accumulation's epilogue (JAX ``_apply_accumulated`` :513):
        grads and metrics divided by ``accum_steps`` in fp32, one optimizer
        and EMA step, the centers from the pooled statistics."""
        grads = [a.float() / accum for a in g_sum]
        metrics = {k: v / accum for k, v in m_sum.items()}

        def centers(st):
            if c_sum is None:
                return
            pooled_centers(st, reduce_center_stats(c_sum))

        return finish(state, grads, metrics, centers)

    def pooled_centers(st: TrainState, stats) -> None:
        """The center EMAs from pooled statistics (JAX :513)."""
        cls_sum, cls_n, masked_sum, w_sum = stats
        m_c = tcfg.center_momentum
        st.dino_center = m_c * st.dino_center + (1.0 - m_c) * cls_sum / torch.clamp(cls_n, min=1.0)
        st.ibot_center = (m_c * st.ibot_center
                          + (1.0 - m_c) * masked_sum / torch.clamp(w_sum, min=1.0))

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None, draws=None):
        if accum > 1:
            return run_host_accum_step(train_step, tcfg, state, batch, generator, draws)
        draws = resolve_draws(state, batch, generator, draws)
        grads, metrics, aux, ssl = loss_and_grads(state, batch, draws)

        def centers(st):
            if aux is None:
                return
            if data is not None:
                pooled_centers(st, reduce_center_stats(_center_stats(aux, ssl)))
                return
            t_cls_head, t_masked_head = aux
            st.dino_center = update_center(st.dino_center, t_cls_head, tcfg.center_momentum)
            st.ibot_center = update_center(st.ibot_center, t_masked_head, tcfg.center_momentum,
                                           weight=ssl["mask_weight"])

        return finish(state, grads, metrics, centers)

    def objective_grad_norms(state: TrainState, batch: Dict[str, Any],
                             generator: Optional[torch.Generator] = None, draws=None
                             ) -> Dict[str, torch.Tensor]:
        """The global gradient norm of each objective alone (JAX :600): one
        forward and backward per objective, all on the same draws; a
        diagnostic of what the summed ``grad_norm`` hides, such as the iBOT x
        drop-path zero-row spike. ``batch`` is one microbatch (no accum axis)."""
        draws = resolve_draws(state, batch, generator, draws)
        batch, draws = localize(batch, draws)
        names = trained(state)
        leaf_params = params(state, names)

        def norm(loss_fn):
            with saving(state):
                loss = loss_fn()
            gs = torch.autograd.grad(loss, leaf_params, allow_unused=True)
            if mesh is None:
                return torch.sqrt(sum(g.float().square().sum() for g in gs if g is not None))
            gs = reduce_grads(state, gs)
            return torch.sqrt(global_norm_sq(dict(zip(names, gs)), sharded_over(state)))

        model, norms = state.model, {}
        if "clip" in branches(batch):
            norms["grad_norm/clip"] = norm(lambda: clip_branch(
                model, batch["image"], batch["text"], draws.get("clip")))
        if "rec" in branches(batch):
            norms["grad_norm/rec"] = norm(lambda: rec_branch(model, batch["rec_image"],
                                                             draws.get("rec")))
        if "ssl" in branches(batch):
            for i, name in enumerate(("dino", "ibot", "koleo")):
                norms[f"grad_norm/{name}"] = norm(
                    lambda i=i: ssl_branch(state, batch["ssl"], draws.get("ssl"))[i])
        return {k: v.detach() for k, v in norms.items()}

    train_step.sample_draws = sample_draws
    train_step.micro_step = micro_step
    train_step.zero_accumulators = zero_accumulators
    train_step.apply_accum = apply_accum
    train_step.objective_grad_norms = objective_grad_norms
    return train_step


def run_host_accum_step(train_step, tcfg: TrainConfig, state: TrainState, batch: Dict[str, Any],
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Sequence[Dict]] = None):
    """One optimizer step of host-driven accumulation (JAX :639): every batch
    leaf carries a leading (accum_steps,) axis. ``draws`` gives one entry per
    microbatch; without it each microbatch's are drawn from ``generator``."""
    accum = max(1, tcfg.accum_steps)
    g_sum, m_sum, c_sum = train_step.zero_accumulators(state, _micro(batch, 0))
    for i in range(accum):
        micro = _micro(batch, i)
        g_sum, m_sum, c_sum = train_step.micro_step(
            state, g_sum, m_sum, c_sum, micro, generator,
            draws[i] if draws is not None else None)
    return train_step.apply_accum(state, g_sum, m_sum, c_sum)
