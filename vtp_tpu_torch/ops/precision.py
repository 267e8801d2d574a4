"""fp32 matrix products at the JAX package's two decode precisions.

``"float32"`` is the exact product (TF32 off on the card). ``"high"`` is
the bf16x3 split, XLA's ``Precision.HIGH`` on the TPU: the JAX package
selects it with ``jax.default_matmul_precision("high")``
(``vtp_tpu/models/pixel_decoder.py:90-118``) and spells it out inside its
fused attention kernel (``mxu_dot``, ``vtp_tpu/ops/flash_attention.py:516-526``).
Each fp32 operand x is split into bf16 halves, hi = bf16(x) and
lo = bf16(x - hi); the product is hi·hi + hi·lo + lo·hi, accumulated and
returned in fp32, and the lo·lo term is dropped.

On a CUDA tensor ``linear_high`` runs one bf16 tensor-core GEMM over the
operands concatenated along K, ``[x_hi | x_hi | x_lo] · [w_hi ; w_lo ; w_hi]``,
with fp32 output (``torch.mm(..., out_dtype=torch.float32)``, cuBLAS; the
JAX package leaves this GEMM to XLA, outside any Pallas kernel). On a CPU
tensor it, like ``matmul_high_reference``, computes the same split in fp32:
a product of two bf16 values is exact in fp32, so only the sum order
differs. Neither is torch's own ``"high"`` (single-pass TF32) nor a single
bf16 pass, which keep about 1e-3 of the product where this keeps about 1e-5.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vtp_tpu_torch.ops.dispatch import on_kernel_device

PRECISIONS = ("float32", "high")


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"fp32 precision must be one of {PRECISIONS}; got {precision!r}")


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 halves of an fp32 tensor: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def matmul_high_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``torch.matmul`` broadcasting) of fp32 tensors as
    hi·hi + hi·lo + lo·hi, each product in fp32, summed in that order (as
    ``mxu_dot`` sums its three dots)."""
    a_hi, a_lo = (t.float() for t in split_bf16(a))
    b_hi, b_lo = (t.float() for t in split_bf16(b))
    return torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)


def linear_high(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` for fp32 x (..., K) and weight (N, K) at "high"."""
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError(f"'high' takes fp32 operands; got {x.dtype} and {weight.dtype}")
    if not on_kernel_device(x):
        return matmul_high_reference(x, weight.t())
    n, k = weight.shape
    x_hi, x_lo = split_bf16(x.reshape(-1, k))
    w_hi, w_lo = split_bf16(weight)
    a = torch.cat([x_hi, x_hi, x_lo], dim=1)
    b = torch.cat([w_hi, w_lo, w_hi], dim=1)
    return torch.mm(a, b.t(), out_dtype=torch.float32).reshape(*x.shape[:-1], n)
