"""The DiT training step and the latent-shard dataset (port of
``vtp_tpu/dit/train.py``: ``DiTTrainConfig`` :27, ``make_dit_optimizer``
:67, ``init_dit_state`` :84, ``build_dit_train_step`` :143, the host-driven
accumulation ``build_dit_microbatch_steps`` / ``run_accum_step`` /
``zero_grad_accumulators`` :173-234, ``LatentShardDataset`` :237).

One step: classifier-free label dropout, the flow-matching losses of
``transport.training_losses`` through ``DiT.forward`` (bf16 compute, remat
on by default; every policy of ``models/blocks.checkpoint_policy``), one
backward, clip by global norm, AdamW (a constant learning rate without
warmup, else warmup-cosine; fp32 or bf16 moments), and the EMA of every
parameter and the RoPE periods at ``ema_decay``. The state is updated in
place.

With ``accum_steps > 1`` the latents and labels carry a leading
microbatch axis and the step is the JAX package's host-driven pair, which
``tools/train_dit.py`` runs (:109-128, 147-151): the gradient sums start
from zeros in ``accum_dtype`` (``zero_grad_accumulators``), each
microbatch adds in fp32 and stores in ``accum_dtype``, and the sums are
divided by ``accum_steps`` in fp32 before the one update; the metrics are
averaged. The JAX package's in-jit scan (``build_dit_train_step``,
:142-168) accumulates in fp32 always, from the first microbatch's
gradients; in fp32 the two agree bit for bit (0 + g = g).
``unroll_layers`` changes nothing here (the depth loop is a Python loop).

Over a mesh (``build_dit_train_step(cfg, tcfg, mesh)``, the JAX CLI's data
parallelism, ``tools/train_dit.py`` :118-145) the state is replicated and
every rank passes the same global batch and generator (or draws): the
label-dropout mask, ``t`` and ``x0`` are drawn for the global batch, each
rank runs its rows, its losses are its share of the global means, and the
gradients and metrics are summed over the ranks in one explicit collective
before the update.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from vtp_tpu_torch.convert.safetensors_io import load_safetensors, read_safetensors_header
from vtp_tpu_torch.dit.model import DiT, DiTConfig
from vtp_tpu_torch.dit.transport import metric_keys, sample_timesteps, training_losses
from vtp_tpu_torch.generation.latents import list_latent_shards, load_latent_stats
from vtp_tpu_torch.parallel.mesh import DATA_AXIS, axis_group
from vtp_tpu_torch.parallel.sharding import shard_batch
from vtp_tpu_torch.train.optim import (
    ACCUM_DTYPES,
    AdamW,
    accumulate_grads,
    all_reduce_flat,
    resolve_moment_dtype,
)
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


def check_config(tcfg: DiTTrainConfig) -> None:
    """Raise ``ValueError`` for an unknown ``accum_dtype`` or ``moment_dtype``."""
    if tcfg.accum_dtype not in ACCUM_DTYPES:
        raise ValueError(f"unknown accum_dtype {tcfg.accum_dtype!r} (use 'fp32' or 'bf16')")
    resolve_moment_dtype(tcfg.moment_dtype)


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
    check_config(tcfg)
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


def zero_grad_accumulators(leaves: List[torch.Tensor], tcfg: DiTTrainConfig,
                           device) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Fresh gradient sums, zeros in ``accum_dtype`` shaped like ``leaves``,
    and metric sums, fp32 zeros under ``transport.metric_keys``."""
    adt = ACCUM_DTYPES[tcfg.accum_dtype]
    g_sum = [torch.zeros_like(p, dtype=adt) for p in leaves]
    m_sum = {k: torch.zeros((), device=device) for k in metric_keys(tcfg.use_cosine_loss)}
    return g_sum, m_sum


def build_dit_train_step(cfg: DiTConfig, tcfg: DiTTrainConfig, mesh=None):
    """Returns ``train_step(state, latents, labels, generator, draws=None)
    -> (state, metrics)``. ``draws`` may give, per microbatch, the label
    dropout mask ``drop`` (B,) bool and the transport's ``t`` and ``x0``,
    with the latents' leading microbatch axis when ``accum_steps > 1``;
    what it lacks is drawn from ``generator`` (drop, then t, then x0).
    Over ``mesh``, data-parallel on the global batch every rank passes."""
    check_config(tcfg)
    cdt = tcfg.torch_compute_dtype
    accum = max(1, int(tcfg.accum_steps))
    data = axis_group(mesh, DATA_AXIS)

    def shard(latents, labels, generator, draws):
        """The global microbatch's draws completed, then this rank's rows."""
        draws = dict(draws)
        if "drop" not in draws:
            draws["drop"] = torch.rand(labels.shape, generator=generator,
                                       device=labels.device) < tcfg.class_dropout_prob
        if "t" not in draws:
            draws["t"] = sample_timesteps(generator, latents.shape[0],
                                          use_lognorm=tcfg.use_lognorm, mu=tcfg.lognorm_mu,
                                          sigma=tcfg.lognorm_sigma, device=latents.device)
        if "x0" not in draws:
            draws["x0"] = torch.randn(latents.shape, generator=generator,
                                      device=latents.device, dtype=latents.dtype)
        rows = lambda t: shard_batch(t, mesh)
        return rows(latents), rows(labels), {k: rows(v) for k, v in draws.items()}

    def loss_and_grads(state: DiTState, names, latents, labels, generator, draws):
        if data is not None:
            latents, labels, draws = shard(latents, labels, generator, draws)
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
        if data is not None:
            loss = loss / data.size
            metrics = dict(zip(metrics, all_reduce_flat(
                [v.detach() / data.size for v in metrics.values()], data)))
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(leaves[n]) for g, n in zip(grads, names)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: DiTState, latents: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator],
                   draws: Optional[Mapping[str, torch.Tensor]] = None):
        draws = draws or {}
        names = [n for n, t in state.optimizer.leaves.items() if t.requires_grad]
        if accum == 1:
            grads, metrics = loss_and_grads(state, names, latents, labels, generator, draws)
        else:
            leaves = state.optimizer.leaves
            g_sum, m_sum = zero_grad_accumulators([leaves[n] for n in names], tcfg,
                                                  latents.device)
            for i in range(accum):
                g, m = loss_and_grads(state, names, latents[i], labels[i], generator,
                                      {k: v[i] for k, v in draws.items()})
                accumulate_grads(g_sum, g)
                m_sum = {k: m_sum[k] + m[k] for k in m_sum}
                del g
            grads = [x.float() / accum for x in g_sum]
            del g_sum
            metrics = {k: v / accum for k, v in m_sum.items()}
        if data is not None:
            grads = all_reduce_flat(grads, data)
        metrics["grad_norm"] = state.optimizer.step(dict(zip(names, grads)))
        del grads
        ema_update(nn.ModuleDict({"dit": state.ema}), {"dit": state.model}, tcfg.ema_decay)
        state.step += 1
        return state, metrics

    return train_step


class LatentShardDataset:
    """Batches ``(latents, labels)`` from extracted latent shards
    (``generation/latents.py``), normalised by the per-channel statistics
    and flipped by taking rows of the precomputed ``latents_flip``. The
    draws are the JAX package's, from ``np.random.default_rng(seed)`` in
    its order (shard order, row permutation, flip draw, each epoch), so a
    seed gives both packages the same batches bit for bit: fp32 latents
    (B, d, h, w) and int32 labels (B,), as tensors on ``device``."""

    def __init__(self, shard_dir: str, *, latent_norm: bool = True, seed: int = 0,
                 device="cuda"):
        self.paths = list_latent_shards(shard_dir)
        if not self.paths:
            raise FileNotFoundError(f"no latent shards in {shard_dir}")
        self.mean = self.std = None
        if latent_norm:
            mean, std = load_latent_stats(shard_dir)
            self.mean, self.std = mean.astype(np.float32), std.astype(np.float32)
        self.seed = seed
        self.device = device

    def batches(self, batch_size: int,
                skip: int = 0) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """An endless stream of batches; the tail of each shard that does not
        fill a batch is skipped. The first ``skip`` batches are drawn but not
        read (a resumed run's stream; a shard's rows come from its header).
        Raises if no shard holds ``batch_size`` rows."""
        rng = np.random.default_rng(self.seed)
        while True:
            yielded = False
            for pi in rng.permutation(len(self.paths)):
                n = read_safetensors_header(self.paths[pi])[1]["latents"]["shape"][0]
                perm = rng.permutation(n)
                shard = None
                for s in range(0, n - batch_size + 1, batch_size):
                    idx = perm[s:s + batch_size]
                    flip = rng.random(batch_size) < 0.5
                    yielded = True
                    if skip:
                        skip -= 1
                        continue
                    if shard is None:
                        shard = load_safetensors(self.paths[pi])
                    z = np.where(flip[:, None, None, None], shard["latents_flip"][idx],
                                 shard["latents"][idx]).astype(np.float32)
                    if self.mean is not None:
                        z = (z - self.mean) / self.std
                    labels = shard["labels"][idx].astype(np.int32)
                    yield (torch.from_numpy(z).to(self.device),
                           torch.from_numpy(labels).to(self.device))
            if not yielded:
                raise ValueError(f"no shard holds a batch of {batch_size} rows")
