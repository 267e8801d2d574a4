"""Linear probing on frozen trunk features (port of
``vtp_tpu/eval/linear_probe.py``; behavioural reference
``tools/test_linear_probing_hf.py``).

Frozen features are the last four intermediate layers with their class
tokens (bf16 encode, no bottleneck). A grid of linear heads, {n_blocks in
(1, 4)} x {13 learning rates} x avgpool, is trained at once with SGD
(momentum 0.9, no weight decay) under a cosine schedule; a head's input is
the last n class tokens and the mean patch token of the last layer; the lr
is scaled by global_batch / 256; the best head is reported.

The 13 same-shape heads of a block count are one stacked (L, in, C) weight,
so they train as one batched product (``einsum("bi,lic->lbc")``) with their
rates a broadcast vector in the hand-written SGD update (``torch.optim``
takes one rate a parameter group). The heads are plain fp32 products, as in
JAX, with TF32 off on the card (``exact_fp32``). The train step is
functional: it returns a new state and leaves the one it was given as it was.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vtp_tpu_torch.config import VTPConfig
from vtp_tpu_torch.models.pixel_decoder import exact_fp32

DEFAULT_LEARNING_RATES = (
    1e-5, 2e-5, 5e-5, 1e-4, 2e-4, 5e-4,
    1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 0.1,
)
MOMENTUM = 0.9


@dataclasses.dataclass
class ProbeConfig:
    n_last_blocks_list: Tuple[int, ...] = (1, 4)
    learning_rates: Tuple[float, ...] = DEFAULT_LEARNING_RATES
    num_classes: int = 1000
    epochs: int = 10
    epoch_length: int = 1250
    batch_size: int = 128
    feature_blocks: int = 4  # trunk layers fetched once a batch

    @property
    def max_iter(self) -> int:
        return self.epochs * self.epoch_length


@torch.no_grad()
def extract_features(model, images: torch.Tensor, n_last_blocks: int = 4,
                     compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> Tuple:
    """The frozen features (test_linear_probing_hf.py:109-130): the last
    ``n_last_blocks`` layers' normed (patch tokens, class token) pairs,
    as ``VTPModel.get_intermediate_layers_feature(n, return_class_token=True)``
    gives them, encoded in ``compute_dtype``."""
    return model.trunk.get_intermediate_layers(images, n_last_blocks, return_class_token=True,
                                               norm=True, compute_dtype=compute_dtype)


def create_linear_input(feats, use_n_blocks: int, use_avgpool: bool = True) -> torch.Tensor:
    """The last n class tokens concatenated (+ the mean patch token of the
    last layer), cast to fp32 (test_linear_probing_hf.py:137-152)."""
    last = feats[-use_n_blocks:]
    out = torch.cat([cls for _, cls in last], dim=-1)
    if use_avgpool:
        out = torch.cat([out, last[-1][0].mean(dim=1)], dim=-1)
    return out.float()


def init_probe_heads(cfg: VTPConfig, pcfg: ProbeConfig, global_batch: int,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Stacked heads a block count: weights N(0, 0.01²), zero bias
    (test_linear_probing_hf.py:162-165), lr = base * global_batch / 256.
    ``generator`` lives on ``device`` (seeded with 0 when not given)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    L = len(pcfg.learning_rates)
    lr = torch.tensor([r * global_batch / 256.0 for r in pcfg.learning_rates],
                      dtype=torch.float32, device=device)
    heads = {}
    for n in pcfg.n_last_blocks_list:
        in_dim = cfg.vision_embed_dim * (n + 1)  # n class tokens + the avgpool
        w = torch.randn((L, in_dim, pcfg.num_classes), generator=generator, device=device)
        heads[f"n{n}"] = {"w": 0.01 * w,
                          "b": torch.zeros((L, pcfg.num_classes), device=device),
                          "lr": lr.clone()}
    return heads


def init_probe_state(heads: Dict[str, Dict[str, torch.Tensor]]) -> Dict:
    """{"heads", "momentum" (zeros), "step" (a 0-d int32 tensor)}."""
    device = next(iter(heads.values()))["w"].device
    return {
        "heads": heads,
        "momentum": {k: {"w": torch.zeros_like(h["w"]), "b": torch.zeros_like(h["b"])}
                     for k, h in heads.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def head_logits(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, in) x (L, in, C) -> (L, B, C)."""
    return torch.einsum("bi,lic->lbc", x, w) + b[:, None, :]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean CE a head: logits (L, B, C) -> (L,)."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels[None, :, None].expand(logits.shape[0], -1, 1))[..., 0]
    return -picked.mean(dim=-1)


def cosine_lr_scale(step: torch.Tensor, max_iter: int) -> torch.Tensor:
    """0.5 (1 + cos(pi t)), t = step / max_iter clipped to [0, 1], in fp32."""
    t = (step.float() / max_iter).clamp(0.0, 1.0)
    return 0.5 * (1.0 + torch.cos(math.pi * t))


def build_probe_train_step(model, pcfg: ProbeConfig,
                           compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> Callable:
    """Returns ``step(state, images, labels) -> (new_state, loss)``: the loss
    is the sum of every head's mean CE; the features carry no gradient; SGD
    with momentum as the JAX step writes it (m = 0.9 m + g; w -= lr * scale
    * m), the cosine scale read at the state's step before it is advanced."""

    def step_fn(state: Dict, images: torch.Tensor, labels: torch.Tensor):
        feats = extract_features(model, images, pcfg.feature_blocks, compute_dtype)
        heads = state["heads"]
        with exact_fp32(), torch.enable_grad():
            leaves = {k: (h["w"].detach().requires_grad_(), h["b"].detach().requires_grad_())
                      for k, h in heads.items()}
            loss = 0.0
            for n in pcfg.n_last_blocks_list:
                x = create_linear_input(feats, n)
                loss = loss + cross_entropy(head_logits(*leaves[f"n{n}"], x), labels).sum()
            keys = list(leaves)
            g = torch.autograd.grad(loss, [t for k in keys for t in leaves[k]])
            grads = {k: (g[2 * i], g[2 * i + 1]) for i, k in enumerate(keys)}
        scale = cosine_lr_scale(state["step"], pcfg.max_iter)
        new_heads, new_mom = {}, {}
        with torch.no_grad():
            for key, h in heads.items():
                gw, gb = grads[key]
                m = state["momentum"][key]
                lr = h["lr"] * scale
                mw = MOMENTUM * m["w"] + gw
                mb = MOMENTUM * m["b"] + gb
                new_heads[key] = {"w": h["w"] - lr[:, None, None] * mw,
                                  "b": h["b"] - lr[:, None] * mb, "lr": h["lr"]}
                new_mom[key] = {"w": mw, "b": mb}
        return {"heads": new_heads, "momentum": new_mom, "step": state["step"] + 1}, loss.detach()

    return step_fn


def build_probe_eval_step(model, pcfg: ProbeConfig,
                          compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> Callable:
    """Returns ``eval(heads, images, labels) -> {group: (L,) hit counts}``."""

    @torch.no_grad()
    def eval_fn(heads: Dict, images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = extract_features(model, images, pcfg.feature_blocks, compute_dtype)
        counts = {}
        with exact_fp32():
            for n in pcfg.n_last_blocks_list:
                h = heads[f"n{n}"]
                pred = head_logits(h["w"], h["b"], create_linear_input(feats, n)).argmax(-1)
                counts[f"n{n}"] = (pred == labels[None, :]).sum(-1)
        return counts

    return eval_fn


def head_names(pcfg: ProbeConfig, global_batch: int) -> Dict[str, Tuple[str, int]]:
    """Classifier key (the reference's naming) -> (group, index in group)."""
    names = {}
    for n in pcfg.n_last_blocks_list:
        for i, base in enumerate(pcfg.learning_rates):
            lr = base * global_batch / 256.0
            key = f"classifier_{n}_blocks_avgpool_True_lr_{lr:.5f}".replace(".", "_")
            names[key] = (f"n{n}", i)
    return names


def evaluate_linear_probe(model, state: Dict, val_loader, pcfg: ProbeConfig,
                          compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                          progress: bool = False) -> Dict[str, float]:
    """Accuracy (%) a head over ``val_loader``'s (images, labels) batches
    (test_linear_probing_hf.py:302-345). The heads are named by
    ``pcfg.batch_size``, not by the global batch, as the JAX function names
    them (``vtp_tpu/eval/linear_probe.py:174-183``)."""
    eval_fn = build_probe_eval_step(model, pcfg, compute_dtype)
    device = next(iter(state["heads"].values()))["w"].device
    totals = {f"n{n}": torch.zeros(len(pcfg.learning_rates), dtype=torch.int64, device=device)
              for n in pcfg.n_last_blocks_list}
    n_total = 0
    it = val_loader
    if progress:
        from tqdm import tqdm  # type: ignore

        it = tqdm(val_loader, desc="probe eval")
    for images, labels in it:
        images = torch.as_tensor(images).to(device)
        labels = torch.as_tensor(np.asarray(labels) if not isinstance(labels, torch.Tensor)
                                 else labels).to(device=device, dtype=torch.int64)
        for k, v in eval_fn(state["heads"], images, labels).items():
            totals[k] += v
        n_total += labels.shape[0]
    counts = {k: v.cpu().numpy() for k, v in totals.items()}
    return {key: 100.0 * float(counts[group][idx]) / max(n_total, 1)
            for key, (group, idx) in head_names(pcfg, pcfg.batch_size).items()}

