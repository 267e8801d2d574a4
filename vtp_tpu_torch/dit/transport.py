"""Flow-matching transport: linear path, velocity prediction, euler ODE
(port of ``vtp_tpu/dit/transport.py``: ``sample_timesteps`` :23,
``training_losses`` :37, ``metric_keys`` :82, ``shift_timesteps`` :93,
``euler_sample`` :102).

Conventions: t in [0, 1]; x_t = t * x1 + (1 - t) * x0 with x0 ~ N(0, I)
noise and x1 data; velocity target v = x1 - x0.

Random draws come from a ``torch.Generator``. Each function that draws
also takes the draws themselves (``t`` and ``x0`` in ``draws``, the
sampler's initial noise ``x``), which are then used as given, so that a
caller can feed the same numbers to two implementations.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch


def sample_timesteps(generator: Optional[torch.Generator], batch: int, *,
                     use_lognorm: bool = True, mu: float = -0.75, sigma: float = 1.0,
                     device=None) -> torch.Tensor:
    """Logit-normal timestep sampling (t = sigmoid(mu + sigma * eps));
    uniform when disabled."""
    if use_lognorm:
        eps = torch.randn(batch, generator=generator, device=device)
        return torch.sigmoid(mu + sigma * eps)
    return torch.rand(batch, generator=generator, device=device)


def training_losses(
    model_fn: Callable,
    x1: torch.Tensor,
    y: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
    use_lognorm: bool = True,
    mu: float = -0.75,
    sigma: float = 1.0,
    use_cosine_loss: bool = True,
    cosine_weight: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Velocity-matching MSE plus the optional cosine-direction loss.
    ``draws`` may give ``t`` (B,) and ``x0`` (like x1); what it lacks is
    drawn from ``generator``, t first."""
    draws = draws or {}
    B = x1.shape[0]
    t = draws.get("t")
    if t is None:
        t = sample_timesteps(generator, B, use_lognorm=use_lognorm, mu=mu, sigma=sigma,
                             device=x1.device)
    x0 = draws.get("x0")
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
    tb = t[:, None, None, None]
    xt = tb * x1 + (1.0 - tb) * x0
    target = x1 - x0

    pred = model_fn(xt, t, y)
    mse = torch.mean((pred - target) ** 2)
    metrics = {"loss/mse": mse}
    loss = mse
    if use_cosine_loss:
        p = pred.reshape(B, -1)
        g = target.reshape(B, -1)
        # eps inside the sqrt: the zero-init (adaLN-zero) model predicts
        # exactly 0 at step 1, where the plain norm's gradient is 0/0 = NaN
        pn = torch.sqrt(torch.sum(p * p, -1) + 1e-8)
        gn = torch.sqrt(torch.sum(g * g, -1) + 1e-8)
        cos = torch.sum(p * g, -1) / (pn * gn)
        cos_loss = torch.mean(1.0 - cos)
        metrics["loss/cos"] = cos_loss
        loss = loss + cosine_weight * cos_loss
    metrics["loss/transport"] = loss
    return loss, metrics


def metric_keys(use_cosine_loss: bool) -> tuple:
    """Keys of the metrics dict ``training_losses`` returns for this config."""
    keys = ["loss/mse"]
    if use_cosine_loss:
        keys.append("loss/cos")
    keys.append("loss/transport")
    return tuple(keys)


def shift_timesteps(t: torch.Tensor, shift: Optional[float]) -> torch.Tensor:
    """Resolution-dependent timestep shift (SD3-style):
    t' = shift * t / (1 + (shift - 1) * t)."""
    if shift is None or shift == 1.0:
        return t
    return shift * t / (1.0 + (shift - 1.0) * t)


@torch.no_grad()
def euler_sample(
    model_fn: Callable,
    shape: Tuple[int, ...],
    y: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    x: Optional[torch.Tensor] = None,
    num_steps: int = 250,
    timestep_shift: Optional[float] = 0.075,
    cfg_scale: float = 1.0,
    null_label: Optional[int] = None,
) -> torch.Tensor:
    """Integrate dx/dt = v(x, t, y) from t = 0 (noise) to t = 1 (data) with
    euler steps on the shifted fp32 time grid; classifier-free guidance when
    ``cfg_scale != 1`` and a ``null_label`` is given. ``x`` is the initial
    noise, drawn from ``generator`` on the labels' device when not given."""
    if x is None:
        x = torch.randn(shape, generator=generator, device=y.device)
    grid = shift_timesteps(torch.linspace(0.0, 1.0, num_steps + 1, device=x.device),
                           timestep_shift)
    use_cfg = cfg_scale != 1.0 and null_label is not None
    y_null = torch.full_like(y, null_label) if use_cfg else None
    B = shape[0]
    for i in range(num_steps):
        t = grid[i].expand(B)
        v = model_fn(x, t, y)
        if use_cfg:
            v_null = model_fn(x, t, y_null)
            v = v_null + cfg_scale * (v - v_null)
        x = x + (grid[i + 1] - grid[i]) * v
    return x
