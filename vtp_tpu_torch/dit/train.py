"""The DiT training step (port of ``vtp_tpu/dit/train.py``:
``DiTTrainConfig`` :27, ``make_dit_optimizer`` :67, ``init_dit_state``
:84, ``build_dit_train_step`` :143).

One step: classifier-free label dropout, the flow-matching losses of
``transport.training_losses`` through ``DiT.forward`` (bf16 compute, remat
on by default), one backward, clip by global norm, AdamW (a constant
learning rate without warmup, else warmup-cosine), and the EMA of every
parameter and the RoPE periods at ``ema_decay``. With ``accum_steps > 1``
the latents and labels carry a leading microbatch axis; the gradients are
summed in fp32 over the microbatches and averaged with the metrics before
the one update, as the JAX package's in-jit scan does. The state is
updated in place.

The host-driven accumulation of the JAX package
(``build_dit_microbatch_steps``, ``run_accum_step``) is the same loop in
PyTorch and is not given separately. ``accum_dtype="bf16"`` and
``moment_dtype="bf16"`` raise ``NotImplementedError``; ``unroll_layers``
changes nothing here (the depth loop is a Python loop). The latent-shard
dataset (``LatentShardDataset``) is not ported.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Optional, Union

import torch
from torch import nn

from vtp_tpu_torch.dit.model import DiT, DiTConfig
from vtp_tpu_torch.dit.transport import metric_keys, training_losses
from vtp_tpu_torch.train.optim import AdamW
from vtp_tpu_torch.train.state import ema_update


@dataclasses.dataclass(frozen=True)
class DiTTrainConfig:
    """A copy of the JAX package's ``DiTTrainConfig`` (same fields and
    defaults)."""

    learning_rate: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    total_steps: int = 100_000
    warmup_steps: int = 0
    ema_decay: float = 0.9999
    use_lognorm: bool = True
    lognorm_mu: float = -0.75   # VTP-L setup; S/B use (-0.5, 1.25)
    lognorm_sigma: float = 1.0
    use_cosine_loss: bool = True
    class_dropout_prob: float = 0.1
    compute_dtype: Optional[str] = "bf16"
    remat: Union[bool, str] = True
    unroll_layers: bool = False
    accum_steps: int = 1
    accum_dtype: str = "fp32"
    moment_dtype: str = "fp32"

    @property
    def torch_compute_dtype(self) -> Optional[torch.dtype]:
        return {None: None, "bf16": torch.bfloat16, "fp32": None}[self.compute_dtype]


def check_supported(tcfg: DiTTrainConfig) -> None:
    """Raise ``NotImplementedError`` for the options the port does not run."""
    if tcfg.accum_dtype != "fp32":
        raise NotImplementedError(f"accum_dtype={tcfg.accum_dtype!r} is not ported (fp32 only)")
    if tcfg.moment_dtype not in ("fp32", "float32"):
        raise NotImplementedError(f"moment_dtype={tcfg.moment_dtype!r} is not ported (fp32 only)")


class DiTState:
    """The ``model``, its ``ema`` copy, the ``optimizer`` over every leaf
    and the step count."""

    def __init__(self, model: DiT, ema: DiT, optimizer: AdamW):
        self.model, self.ema, self.optimizer = model, ema, optimizer
        self.step = 0


def dit_leaves(model: DiT) -> Dict[str, torch.Tensor]:
    """Every leaf of the JAX parameter tree, by port name: the parameters
    and the ``rope_periods`` buffer, which gets no gradient but is handed
    to AdamW as optax hands it the periods leaf (a weight decay reaches it)."""
    leaves = dict(model.named_parameters())
    leaves["rope_periods"] = model.rope_periods
    return leaves


def make_dit_optimizer(leaves: Dict[str, torch.Tensor], tcfg: DiTTrainConfig) -> AdamW:
    """Clip, then AdamW: a constant learning rate when ``warmup_steps == 0``,
    else ``optax.warmup_cosine_decay_schedule(0, lr, warmup,
    max(total, warmup + 1), 0)``."""
    check_supported(tcfg)
    warmup = tcfg.warmup_steps
    return AdamW(leaves, learning_rate=tcfg.learning_rate, warmup_steps=warmup,
                 total_steps=max(tcfg.total_steps, warmup + 1),
                 weight_decay=tcfg.weight_decay, b1=tcfg.beta1, b2=tcfg.beta2,
                 grad_clip=tcfg.grad_clip, moment_dtype=tcfg.moment_dtype,
                 constant_lr=warmup <= 0)


def init_dit_state(cfg: DiTConfig, tcfg: DiTTrainConfig,
                   generator: Optional[torch.Generator] = None, device="cuda") -> DiTState:
    """A fresh DiT (``DiT.init``), its EMA copy and the optimizer."""
    model = DiT.init(cfg, generator, device=device)
    ema = copy.deepcopy(model).requires_grad_(False)
    return DiTState(model, ema, make_dit_optimizer(dit_leaves(model), tcfg))


def build_dit_train_step(cfg: DiTConfig, tcfg: DiTTrainConfig):
    """Returns ``train_step(state, latents, labels, generator, draws=None)
    -> (state, metrics)``. ``draws`` may give, per microbatch, the label
    dropout mask ``drop`` (B,) bool and the transport's ``t`` and ``x0``,
    with the latents' leading microbatch axis when ``accum_steps > 1``;
    what it lacks is drawn from ``generator`` (drop, then t, then x0)."""
    check_supported(tcfg)
    cdt = tcfg.torch_compute_dtype
    accum = max(1, int(tcfg.accum_steps))

    def loss_and_grads(state: DiTState, names, latents, labels, generator, draws):
        drop = draws.get("drop")
        if drop is None:
            drop = torch.rand(labels.shape, generator=generator,
                              device=labels.device) < tcfg.class_dropout_prob
        y = torch.where(drop, torch.full_like(labels, cfg.null_label), labels)
        model_fn = lambda xt, t, yy: state.model(xt, t, yy, compute_dtype=cdt, remat=tcfg.remat)
        loss, metrics = training_losses(
            model_fn, latents, y, generator=generator, draws=draws,
            use_lognorm=tcfg.use_lognorm, mu=tcfg.lognorm_mu, sigma=tcfg.lognorm_sigma,
            use_cosine_loss=tcfg.use_cosine_loss)
        leaves = state.optimizer.leaves
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: DiTState, latents: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator],
                   draws: Optional[Mapping[str, torch.Tensor]] = None):
        draws = draws or {}
        names = [n for n, t in state.optimizer.leaves.items() if t.requires_grad]
        if accum == 1:
            grads, metrics = loss_and_grads(state, names, latents, labels, generator, draws)
        else:
            g_sum, m_sum = None, dict.fromkeys(metric_keys(tcfg.use_cosine_loss), 0.0)
            for i in range(accum):
                g, m = loss_and_grads(state, names, latents[i], labels[i], generator,
                                      {k: v[i] for k, v in draws.items()})
                g_sum = [x.float() for x in g] if g_sum is None else [
                    a + b.float() for a, b in zip(g_sum, g)]
                m_sum = {k: m_sum[k] + m[k] for k in m_sum}
                del g
            grads = [x / accum for x in g_sum]
            metrics = {k: v / accum for k, v in m_sum.items()}
        metrics["grad_norm"] = state.optimizer.step(dict(zip(names, grads)))
        del grads
        ema_update(nn.ModuleDict({"dit": state.ema}), {"dit": state.model}, tcfg.ema_decay)
        state.step += 1
        return state, metrics

    return train_step
