"""Training state: student model and DINO head, EMA teacher, optimizer,
DINO/iBOT centers (port of ``vtp_tpu/train/state.py``).

The teacher holds EMA copies of the trunk, the CLIP projection and the
DINO head (``make_teacher``); ``ema_update`` is a lerp over their
parameters and buffers. The state is updated in place by a train step.
``load_numpy_train_state`` fills it from a JAX train state given as numpy
arrays under the reference checkpoint's names.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vtp_tpu_torch.models.dino_head import DinoHead
from vtp_tpu_torch.models.vtp_model import VTPModel, checkpoint_name
from vtp_tpu_torch.train.optim import AdamW


def student_parts(model: VTPModel, dino_head: Optional[DinoHead]) -> Dict[str, nn.Module]:
    """The EMA-tracked subset of the student: trunk + visual_proj + dino_head."""
    parts = {"trunk": model.trunk}
    if model.visual_proj is not None:
        parts["visual_proj"] = model.visual_proj
    if dino_head is not None:
        parts["dino_head"] = dino_head
    return parts


def make_teacher(model: VTPModel, dino_head: Optional[DinoHead]) -> nn.ModuleDict:
    """Frozen copies of the EMA-tracked subset."""
    teacher = copy.deepcopy(nn.ModuleDict(student_parts(model, dino_head)))
    teacher.requires_grad_(False)
    return teacher


@torch.no_grad()
def ema_update(teacher: nn.ModuleDict, student: Dict[str, nn.Module], momentum: float) -> None:
    """teacher <- m * teacher + (1 - m) * student, over every floating
    tensor of the teacher's state, RoPE periods included. As in the JAX
    package, the scalars are rounded to the tensor's dtype and each op
    rounds: for the bf16 periods m becomes 0.9921875 and 1 - m 0.0060120,
    so the teacher's periods shrink at each step until rounding stalls them."""
    for name, part in teacher.items():
        src = student[name].state_dict()
        for key, t in part.state_dict().items():
            if t.is_floating_point():
                m = torch.tensor(momentum, dtype=t.dtype, device=t.device)
                one_minus = torch.tensor(1.0 - momentum, dtype=t.dtype, device=t.device)
                t.copy_(m * t + one_minus * src[key])


class TrainState:
    """The student (``model`` and ``dino_head``), the ``teacher``, the
    ``optimizer`` over every trained leaf, the two centers and the step."""

    def __init__(self, model: VTPModel, dino_head: Optional[DinoHead], optimizer: AdamW,
                 teacher: Optional[nn.ModuleDict], dino_center: Optional[torch.Tensor],
                 ibot_center: Optional[torch.Tensor]):
        self.model, self.dino_head, self.optimizer = model, dino_head, optimizer
        self.teacher, self.dino_center, self.ibot_center = teacher, dino_center, ibot_center
        self.step = 0


def train_leaves(model: VTPModel, dino_head: Optional[DinoHead]) -> Dict[str, torch.Tensor]:
    """Every leaf of the JAX parameter tree, by port name: the parameters
    and the RoPE ``periods`` buffers (see ``train/optim.py``)."""
    leaves = dict(model.named_parameters())
    leaves.update((n, b) for n, b in model.named_buffers() if n.endswith("rope_embed.periods"))
    if dino_head is not None:
        leaves.update((f"dino_head.{n}", p) for n, p in dino_head.named_parameters())
    return leaves


def _head_state(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k[len("dino_head."):]: torch.tensor(np.asarray(v)) for k, v in sd.items()
            if k.startswith("dino_head.")}


@torch.no_grad()
def load_numpy_train_state(state: TrainState, params: Dict[str, np.ndarray],
                           teacher: Optional[Dict[str, np.ndarray]] = None,
                           mu: Optional[Dict[str, np.ndarray]] = None,
                           nu: Optional[Dict[str, np.ndarray]] = None, count: int = 0,
                           dino_center: Optional[np.ndarray] = None,
                           ibot_center: Optional[np.ndarray] = None, step: int = 0) -> None:
    """Fill ``state`` from a JAX train state as numpy arrays.

    ``params``, ``teacher``, ``mu`` and ``nu`` are flat dicts under the
    reference checkpoint's names (``vtp_tpu.convert.to_torch.export_state_dict``
    of each tree; the moments have the parameters' tree, so the same
    export applies) plus the DINO head under ``dino_head.`` as
    ``models.dino_head.head_state_dict`` gives it (``mlp.layer{i}.weight`` /
    ``.bias``, ``last_layer.v`` / ``.g`` or, without weight norm,
    ``last_layer.weight``; torch layout). ``count`` is the Adam count."""
    body = {k: v for k, v in params.items() if not k.startswith("dino_head.")}
    state.model.load_numpy_state_dict(body)
    if state.dino_head is not None:
        state.dino_head.load_state_dict(_head_state(params))
    if teacher is not None and state.teacher is not None:
        for name, part in state.teacher.items():
            if name == "dino_head":
                part.load_state_dict(_head_state(teacher))
                continue
            own = part.state_dict()
            for key in own:
                own[key].copy_(torch.tensor(np.asarray(teacher[f"{name}.{key}"])))
    opt = state.optimizer
    for moments, src in ((opt.mu, mu), (opt.nu, nu)):
        if src is None:
            continue
        for n, m in moments.items():
            m.copy_(torch.tensor(np.asarray(src[checkpoint_name(n)])).to(m.dtype))
    opt.count = int(count)
    for attr, value in (("dino_center", dino_center), ("ibot_center", ibot_center)):
        if value is not None:
            getattr(state, attr).copy_(torch.tensor(np.asarray(value, np.float32)))
    state.step = int(step)
