"""Learning-rate, momentum and weight-decay schedules (port of
``vtp_tpu/train/schedules.py``).

``CosineScheduler`` is the reference's precomputed numpy table
(``vtp/models/utils/text_utils.py:160-207``): freeze, linear warmup,
cosine decay, then the final value; indexable by iteration.
``cosine_schedule`` is the same curve as a function of the step, computed
in float32 as the JAX package's traced version is.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class CosineScheduler:
    """Precomputed numpy schedule table, indexable like the reference."""

    def __init__(
        self,
        base_value: float,
        final_value: float,
        total_iters: int,
        warmup_iters: int = 0,
        start_warmup_value: float = 0.0,
        freeze_iters: int = 0,
        trunc_extra: float = 0.0,
    ):
        self.final_value = final_value
        self.total_iters = total_iters

        freeze_schedule = np.zeros(freeze_iters)
        warmup_schedule = np.linspace(start_warmup_value, base_value, warmup_iters)
        trunc_iters = int(trunc_extra * total_iters)
        cosine_iters = max(total_iters - warmup_iters - freeze_iters + trunc_iters, 0)
        iters = np.arange(cosine_iters)
        cosine = final_value + 0.5 * (base_value - final_value) * (
            1 + np.cos(np.pi * iters / max(cosine_iters, 1)))
        schedule = np.concatenate((freeze_schedule, warmup_schedule, cosine))[:total_iters]
        if len(schedule) < total_iters:
            schedule = np.concatenate(
                (schedule, np.full(total_iters - len(schedule), final_value)))
        self.schedule = schedule
        if len(self.schedule) != self.total_iters:
            raise ValueError(f"schedule of {len(self.schedule)} steps, expected {total_iters}")

    def __getitem__(self, it: int) -> float:
        if it >= self.total_iters:
            return float(self.final_value)
        return float(self.schedule[it])


def cosine_schedule(
    base_value: float,
    final_value: float,
    total_steps: int,
    warmup_steps: int = 0,
    start_warmup_value: float = 0.0,
) -> Callable[[int], np.float32]:
    """step -> value: linear warmup from ``start_warmup_value`` over
    ``warmup_steps``, then a cosine from ``base_value`` to ``final_value``
    at ``total_steps``, held there; in float32."""
    f = np.float32

    def fn(step) -> np.float32:
        step = f(step)
        if step < warmup_steps:
            return f(f(start_warmup_value)
                     + f(base_value - start_warmup_value) * (step / f(max(warmup_steps, 1))))
        t = np.clip((step - f(warmup_steps)) / f(max(total_steps - warmup_steps, 1)),
                    f(0), f(1))
        return f(f(final_value) + f(0.5 * (base_value - final_value))
                 * (f(1) + np.cos(f(np.pi) * t)))

    return fn
