"""Small shared utilities (port of ``vtp_tpu/utils/misc.py``:
``cat_keep_shapes`` :18, ``uncat_with_shapes`` :27, ``named_apply`` :35,
``fix_random_seeds`` :48, ``get_sha`` :56, ``to_ntuple`` :71,
``as_jax_dtype`` :101, here ``as_torch_dtype``)."""

from __future__ import annotations

import collections.abc
import math
import random
import subprocess
from itertools import repeat
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vtp_tpu_torch.models.blocks import pack, unpack


def cat_keep_shapes(x_list: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, List[Tuple[int, ...]], List[int]]:
    """Flatten a list of (..., D) tensors into one (sum, D) matrix, with each
    tensor's shape and row count (``models.blocks.pack``)."""
    shapes = [tuple(x.shape) for x in x_list]
    return pack(x_list), shapes, [math.prod(s[:-1]) for s in shapes]


def uncat_with_shapes(flat: torch.Tensor, shapes: Sequence[Tuple[int, ...]],
                      num_tokens: Sequence[int]) -> List[torch.Tensor]:
    """The inverse of ``cat_keep_shapes`` (``models.blocks.unpack``)."""
    if [math.prod(s[:-1]) for s in shapes] != list(num_tokens):
        raise ValueError(f"row counts {list(num_tokens)} do not match the shapes {list(shapes)}")
    return unpack(flat, shapes)


def named_apply(fn: Callable[[Tuple[str, ...], torch.Tensor], Any], module: nn.Module
                ) -> Dict[str, Any]:
    """``fn(path, tensor)`` over ``module``'s named parameters, the path a
    tuple of attribute names: ``{dotted name: result}``, the counterpart of
    the JAX function's new tree."""
    return {name: fn(tuple(name.split(".")), p) for name, p in module.named_parameters()}


def fix_random_seeds(seed: int = 31, device="cuda") -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators and return a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (the JAX function
    returns a key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def get_sha() -> str:
    """The git SHA of the working tree, "(dirty)" if it has changes, or
    "unknown" outside a repository."""
    try:
        sha = subprocess.check_output(["git", "rev-parse", "HEAD"],
                                      stderr=subprocess.DEVNULL).decode().strip()
        dirty = subprocess.call(["git", "diff", "--quiet"], stderr=subprocess.DEVNULL) != 0
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
    return sha + (" (dirty)" if dirty else "")


def to_ntuple(n: int):
    """timm-style argument-to-tuple helper."""

    def parse(x):
        if isinstance(x, collections.abc.Iterable) and not isinstance(x, str):
            return tuple(x)
        return tuple(repeat(x, n))

    return parse


to_2tuple = to_ntuple(2)

_NAMED = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16,
          "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}
_NP_TO_TORCH = {np.dtype(k): v for k, v in (
    ("bool", torch.bool), ("uint8", torch.uint8), ("int8", torch.int8),
    ("int16", torch.int16), ("int32", torch.int32), ("int64", torch.int64),
    ("float16", torch.float16), ("float32", torch.float32), ("float64", torch.float64))}


def as_torch_dtype(spec) -> torch.dtype:
    """A dtype name ("bf16", "fp32", "int8", ...), numpy dtype or torch dtype
    -> the torch dtype."""
    if isinstance(spec, torch.dtype):
        return spec
    if isinstance(spec, str) and spec in _NAMED:
        return _NAMED[spec]
    d = np.dtype(spec)
    if d not in _NP_TO_TORCH:
        raise ValueError(f"no torch dtype for {spec!r}")
    return _NP_TO_TORCH[d]
