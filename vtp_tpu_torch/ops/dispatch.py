"""Kernel-or-plain selection, by the tensor's device alone.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
kernel's plain PyTorch version. There is no switch that sends a CUDA
tensor to the plain version: on the card a wrapper launches its kernel
or raises. ``chip_smoke.py`` calls the plain functions by name when it
holds a kernel against them.

Every wrapper counts its launches here, one per launch of its kernel and
nowhere else, so that a run can show that its main path went through the
kernels (``reset_launch_counts`` before, ``launch_counts`` after).
"""

from __future__ import annotations

from typing import Dict

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
