"""Int8 W8A8 serving quantization (port of ``vtp_tpu/utils/quantization.py``:
``quantize_kernel`` :30, ``int8_linear`` :44, ``quantize_matmul_params``
:62).

Weights are quantized per output channel to symmetric int8 with fp32
scales; each product runs int8 x int8 -> int32 (``torch._int_mm``: cuBLASLt
on the card, exact, so the CPU and the card agree bit for bit) on inputs
quantized per row at run time, then rescaled. Torch weights are
``(out, in)``, so the amax is over the last dim, and the codes stay in that
layout: ``q.t()`` is the column-major operand ``_int_mm`` takes, so no call
copies a weight.

The quantized form is :class:`Int8Weight`, a module holding the codes ``q``
and the scales ``scale`` (the JAX ``{q, scale}``; the ``bias`` stays where
it was, beside it). ``quantize_matmul_params`` puts one in place of each
weight that the forwards feed to ``ops.ffn.linear``, which dispatches on
it, so there is no separate int8 model code: a quantized ``nn.Linear``
keeps its name and reads ``<name>.weight.q``, ``<name>.weight.scale``,
``<name>.bias``.

Quality: int8 shifts the metrics; the parity protocol stays bf16/fp32.
This is the serving-throughput option (bulk latent extraction, DiT
sampling). Training needs the float weights.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import nn

# ``torch._int_mm`` on CUDA takes more than 16 rows, and inner and output
# sizes that are multiples of 8; fewer rows are padded with zero rows.
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8
# The JAX default: the consumers that read their weight directly instead of
# through ``linear`` (patchify's reshape-GEMM, the feature bottleneck)
DEFAULT_EXCLUDE = ("patch_embed", "feature_bottleneck")


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., out, in)`` float -> (q: int8 of the same shape, scale: fp32
    ``(..., out)``): symmetric per output channel; leading (e.g. depth) axes
    quantize independently. The JAX operations in the JAX order, so the
    codes and scales equal JAX's on the same fp32 weights."""
    w = weight.detach().float()
    amax = w.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale[..., None]), -127, 127).to(torch.int8)
    return q.contiguous(), scale


class Int8Weight(nn.Module):
    """A linear weight in int8: codes ``q`` ``(out, in)`` and fp32 scales
    ``scale`` ``(out,)``, as buffers (``ops.ffn.linear`` takes it where it
    takes a float weight)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        if q.dtype != torch.int8 or q.dim() != 2 or tuple(scale.shape) != (q.shape[0],):
            raise ValueError(f"int8 weight: q {q.dtype} {tuple(q.shape)}, scale "
                             f"{tuple(scale.shape)}")
        self.register_buffer("q", q.contiguous())
        self.register_buffer("scale", scale.float())

    @classmethod
    def quantize(cls, weight: torch.Tensor) -> "Int8Weight":
        """From a float ``(out, in)`` weight."""
        return cls(*quantize_kernel(weight))

    def dequantize(self) -> torch.Tensor:
        """The fp32 ``(out, in)`` weight the codes stand for."""
        return self.q.float() * self.scale[:, None]

    def extra_repr(self) -> str:
        return f"out={self.q.shape[0]}, in={self.q.shape[1]}"


def int8_matmul(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``xq @ q.T`` in int32 for int8 ``xq`` (m, in) and ``q`` (out, in), by
    ``torch._int_mm`` on ``q.t()``. Fewer than ``INT_MM_MIN_ROWS`` rows are
    padded with zero rows and the result sliced, on every device, so the CPU
    runs the card's path. On a CUDA tensor an inner or output size that is
    not a multiple of 8 raises: there is no float fallback."""
    m, k = xq.shape
    if xq.is_cuda and (k % INT_MM_ALIGN or q.shape[0] % INT_MM_ALIGN):
        raise ValueError(f"int8 GEMM ({m}, {k}) x ({k}, {q.shape[0]}): torch._int_mm on CUDA "
                         f"needs inner and output sizes that are multiples of {INT_MM_ALIGN}")
    if m < INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros((INT_MM_MIN_ROWS - m, k))])
    acc = torch._int_mm(xq, q.t())
    return acc[:m] if m < INT_MM_MIN_ROWS else acc


def int8_linear(x: torch.Tensor, weight: Int8Weight,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row dynamic activation quantization and the int8 product:
    ``x`` (..., in) float -> fp32 (..., out), the bias added in fp32."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).float()
    # max |x| of each row (exact, one pass), floored, over 127
    row_amax = torch.linalg.vector_norm(xf, float("inf"), dim=-1, keepdim=True)
    row_scale = torch.clamp(row_amax, min=1e-12) / 127.0
    xq = torch.round(xf / row_scale).clamp_(-127, 127).to(torch.int8)
    out = int8_matmul(xq, weight.q).float().mul_(row_scale).mul_(weight.scale)
    if bias is not None:
        out = out.add_(bias.float())
    return out.reshape(*shape[:-1], -1)


def shallow_copy(module: nn.Module) -> nn.Module:
    """A new module object with its own parameter, buffer and child tables,
    sharing every tensor and child with ``module``: replacing an entry of
    the copy leaves ``module`` as it was."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = dict(module._modules)
    return new


def replace_modules(module: nn.Module, fn: Callable[[nn.Module], Optional[nn.Module]],
                    exclude: Callable[[str], bool] = lambda name: False) -> nn.Module:
    """``module`` with ``fn`` applied to it and to every submodule whose
    attribute name ``exclude`` does not refuse: ``fn`` returns a changed copy
    of the module it is given, or None to leave it. The modules on the way
    to a change are shallow copies and everything else is shared, so
    ``module`` is unchanged, and is returned itself when nothing changed."""
    out = fn(module)
    out = module if out is None else out
    for name, child in list(out._modules.items()):
        if child is None or exclude(name):
            continue
        repl = replace_modules(child, fn, exclude)
        if repl is not child:
            if out is module:
                out = shallow_copy(module)
            out._modules[name] = repl
    return out


def linear_weights(module: nn.Module) -> List[Tuple[str, Optional[str], str]]:
    """``(weight name, bias name, layout)`` of each weight that ``module``
    itself feeds to ``ops.ffn.linear``: an ``nn.Linear``'s, a 1x1
    convolution's (the pixel decoder's ``proj_in`` / ``proj_out``, run as
    GEMMs), and the raw parameters that a module lists in
    ``LINEAR_WEIGHTS``. The layout is "out_in" (torch's), "conv" (a 1x1
    kernel, ``(out, in, 1, 1)``) or "in_out" (a bare ``(in, out)`` matrix)."""
    if isinstance(module, nn.Linear):
        entries = [("weight", "bias", "out_in")]
    elif isinstance(module, nn.Conv2d) and module.kernel_size == (1, 1):
        entries = [("weight", "bias", "conv")]
    else:
        entries = getattr(module, "LINEAR_WEIGHTS", ())
    return [e for e in entries if module._parameters.get(e[0]) is not None]


def gemm_weight(weight: Union[torch.Tensor, Int8Weight], layout: str
                ) -> Union[torch.Tensor, Int8Weight]:
    """A weight of ``linear_weights``' layout as ``(out, in)``, the form
    ``ops.ffn.linear`` takes; an ``Int8Weight`` is already in it."""
    if isinstance(weight, Int8Weight):
        return weight
    if layout == "in_out":
        return weight.t()
    return weight.reshape(weight.shape[0], -1) if layout == "conv" else weight


def quantize_matmul_params(module: nn.Module,
                           exclude: Optional[Callable[[str], bool]] = None) -> nn.Module:
    """A copy of ``module`` with every weight it feeds to ``ops.ffn.linear``
    in int8 (an :class:`Int8Weight` under the weight's name; the bias stays).
    Embeddings, norms, tokens and RoPE tables stay as they are, and the
    tensors left in float are shared with ``module``, which is unchanged.

    ``exclude(name)`` skips submodules by attribute name; the default skips
    ``patch_embed`` and ``feature_bottleneck``, which read their weights
    directly (as the JAX default does)."""
    if exclude is None:
        exclude = lambda name: name in DEFAULT_EXCLUDE

    def quantize(m: nn.Module) -> Optional[nn.Module]:
        found = linear_weights(m)
        if not found:
            return None
        new = shallow_copy(m)
        for name, _, layout in found:
            weight = new._parameters.pop(name)
            setattr(new, name, Int8Weight.quantize(gemm_weight(weight, layout)))
        return new

    return replace_modules(module, quantize, exclude)
