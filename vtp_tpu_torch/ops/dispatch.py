"""Kernel-or-plain selection, by the tensor's device alone.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain PyTorch version. There is one scoped switch, for
comparisons: ``plain_kernels()`` (the counterpart of the JAX package's
``kernel_overrides``) runs the kernels' plain versions while it is
entered, on any device, and restores the kernels on exit. Only a
comparison enters it (``chip_smoke.py``, ``tools/parity_probe.py``, the
tests); no main path does, so on the card a wrapper otherwise launches its
kernel or raises.

Every wrapper counts its launches here, one per launch of its kernel and
nowhere else, so that a run can show that its main path went through the
kernels (``reset_launch_counts`` before, ``launch_counts`` after).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

_launches: Dict[str, int] = {}


def on_kernel_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU
    tensor (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def count_launch(name: str) -> None:
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


@contextlib.contextmanager
def plain_kernels() -> Iterator[None]:
    """Run every kernel's plain version while entered: the differentiable
    attention and CE keep their autograd functions, whose forward and
    backward then go to the plain PyTorch versions, so nothing is launched
    (``launch_counts`` does not move). The kernels' entry points come back
    on exit, also when the body raises. Not reentrant from two threads."""
    from vtp_tpu_torch.ops import flash_attention as fa
    from vtp_tpu_torch.ops import fused_ce

    swaps = [(fa, "_forward", fa.fused_qkv_rope_attention_reference),
             (fa, "fused_qkv_rope_attention_bwd", fa.fused_qkv_rope_attention_bwd_reference),
             (fa, "fused_qkv_rope_attention_qk_norm_bwd",
              fa.fused_qkv_rope_attention_qk_norm_bwd_reference),
             (fa, "_flash_bnhd_forward", fa.flash_attention_bnhd_reference),
             (fa, "_flash_forward", fa.flash_attention_reference),
             (fused_ce, "fused_ce_fwd", fused_ce.fused_ce_fwd_reference),
             (fused_ce, "fused_ce_bwd", fused_ce.fused_ce_bwd_reference)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, kernel in saved:
            setattr(mod, name, kernel)
