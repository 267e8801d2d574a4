"""Serving-time parameter transforms (port of ``vtp_tpu/utils/params.py``:
``cast_matmul_params`` :11, ``fuse_ffn_params`` :30, ``param_count`` :51,
``tree_bytes`` :55).

Each transform returns a new module and leaves the one it is given as it
was; the tensors it does not change are shared, not copied. They are for
serving: training needs the fp32 weights and the unfused layout that the
optimizer, the checkpoints and the converters name.
"""

from __future__ import annotations

import torch
from torch import nn

from vtp_tpu_torch.utils.quantization import linear_weights, replace_modules, shallow_copy


def cast_matmul_params(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """A copy of ``module`` with its GEMM weights and their biases stored in
    ``dtype`` where they are fp32: every ``nn.Linear`` and ``nn.Conv2d`` (the
    patch embedding included), and the raw matrices a module lists in
    ``LINEAR_WEIGHTS``. Norm weights and biases, tokens, embeddings and RoPE
    tables stay fp32.

    The bf16 encode rounds each fp32 weight to bf16 at every GEMM anyway
    (``ops.ffn.linear``), so a bf16 encode of the copy gives the same
    latents bit for bit while reading half the weight bytes and skipping
    the per-call casts. (The JAX function casts every leaf named "bias",
    LayerNorm biases included; here those stay fp32.)"""

    def cast(m: nn.Module):
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            names = ["weight", "bias"]
        else:
            names = [n for w, b, _ in linear_weights(m) for n in (w, b) if n is not None]
        names = [n for n in names
                 if m._parameters.get(n) is not None and m._parameters[n].dtype == torch.float32]
        if not names:
            return None
        new = shallow_copy(m)
        for n in names:
            p = m._parameters[n]
            new._parameters[n] = nn.Parameter(p.detach().to(dtype), requires_grad=p.requires_grad)
        return new

    return replace_modules(module, cast)


def fuse_ffn_params(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with each SwiGLU FFN (a module with ``w1``,
    ``w2``, ``w3``: ``models.blocks.SwiGLUFFN``) holding one ``w12`` up-
    projection, ``[w1; w2]`` stacked on the output dim, in place of ``w1``
    and ``w2``, which become None: ``ops.ffn.swiglu`` then runs one GEMM
    for the two, one read of its input instead of two. The same arithmetic
    for each output column."""

    def fuse(m: nn.Module):
        w1, w2 = getattr(m, "w1", None), getattr(m, "w2", None)
        if not (isinstance(w1, nn.Linear) and isinstance(w2, nn.Linear)
                and isinstance(getattr(m, "w3", None), nn.Linear)):
            return None
        w12 = nn.Linear(w1.in_features, 2 * w1.out_features, bias=w1.bias is not None,
                        device="meta")
        w12.weight = nn.Parameter(torch.cat([w1.weight.detach(), w2.weight.detach()]),
                                  requires_grad=w1.weight.requires_grad)
        if w1.bias is not None:
            w12.bias = nn.Parameter(torch.cat([w1.bias.detach(), w2.bias.detach()]),
                                    requires_grad=w1.bias.requires_grad)
        new = shallow_copy(m)
        new.w12 = w12
        new.w1 = new.w2 = None
        return new

    return replace_modules(module, fuse)


def param_count(module: nn.Module) -> int:
    """Elements of every tensor in ``module``'s state dict (an int8 weight's
    codes and scales included)."""
    return sum(t.numel() for t in module.state_dict().values())


def tree_bytes(module: nn.Module) -> int:
    """Bytes of every tensor in ``module``'s state dict."""
    return sum(t.numel() * t.element_size() for t in module.state_dict().values())
