"""The head-major qkv parameter layout (port of
``vtp_tpu/parallel/sharding.py:203-250``: ``qkv_head_major`` and
``permute_trunk_qkv``), without the mesh code.

A tensor-parallel run of the JAX package permutes the packed qkv GEMM's
output columns from the canonical [Q|K|V] (head h at h*d within each
third) into ``tp`` rank-major groups [Q_r|K_r|V_r], so that each rank's
contiguous column shard is itself a canonical packed qkv for its H/tp
heads. Rank r holds the contiguous heads [r*H/tp, (r+1)*H/tp), so the
attention output's feature order stays canonical. ``save_pretrained``
keeps that layout, and ``VTPConfig.vision_qkv_head_major`` declares it.

The functions act on numpy arrays and torch tensors alike.
"""

from __future__ import annotations

from typing import Any


def qkv_head_major(w: Any, num_heads: int, tp: int, *, inverse: bool = False) -> Any:
    """Permute the packed-qkv columns on the last dim between the canonical
    [Q|K|V] layout and the ``tp``-rank-major layout (``inverse=True``: back
    to canonical). Works on kernels ``(..., in_dim, 3D)`` and biases
    ``(..., 3D)``; for a torch ``Linear`` weight ``(3D, in)`` pass its
    transpose."""
    if tp <= 1:
        return w
    c = int(w.shape[-1])
    D = c // 3
    if 3 * D != c or D % num_heads or num_heads % tp:
        raise ValueError(
            f"qkv feature dim {c} not permutable: needs 3*H*d columns "
            f"with num_heads={num_heads} divisible by tp={tp}")
    lead = tuple(w.shape[:-1])
    if inverse:
        t = w.reshape(*lead, tp, 3, D // tp).swapaxes(-3, -2)
    else:
        t = w.reshape(*lead, 3, tp, D // tp).swapaxes(-3, -2)
    return t.reshape(*lead, c)


def permute_trunk_qkv(trunk: dict, num_heads: int, tp: int, *, inverse: bool = False) -> dict:
    """Copy of a ViT trunk parameter tree (the JAX package's layout, as
    ``convert.from_torch.convert_state_dict`` builds it) with the stacked
    blocks' qkv kernel and bias permuted to (``inverse=False``) or from
    (``inverse=True``) the head-major layout. Every other leaf is shared,
    not copied."""
    if tp <= 1:
        return trunk
    trunk = dict(trunk)
    blocks = dict(trunk["blocks"])
    attn = dict(blocks["attn"])
    qkv = dict(attn["qkv"])
    # a float {kernel, bias} or an int8 {q, scale, bias}: each on its output dim
    for leaf in ("kernel", "q", "scale", "bias"):
        if qkv.get(leaf) is not None:
            qkv[leaf] = qkv_head_major(qkv[leaf], num_heads, tp, inverse=inverse)
    attn["qkv"] = qkv
    blocks["attn"] = attn
    trunk["blocks"] = blocks
    return trunk


def is_trunk_qkv_key(key: str) -> bool:
    """Whether a reference-named state-dict key is a trunk block's qkv
    weight (float, or an int8 one's codes and scales), bias or bias mask."""
    return key.startswith("trunk.blocks.") and key.endswith(
        (".attn.qkv.weight", ".attn.qkv.bias", ".attn.qkv.bias_mask",
         ".attn.qkv.weight.q", ".attn.qkv.weight.scale"))


def permute_qkv_state_dict(sd: dict, num_heads: int, tp: int, *, inverse: bool = False) -> dict:
    """Copy of a reference-named state dict (torch layouts: a ``Linear``
    weight is ``(out, in)``) with the qkv weight, bias and bias mask of the
    trunk's blocks permuted to (``inverse=False``) or from (``inverse=True``)
    the head-major layout. Every other entry is shared."""
    if tp <= 1:
        return sd
    out = dict(sd)
    for key, value in sd.items():
        if is_trunk_qkv_key(key):
            if key.endswith((".weight", ".weight.q")):
                out[key] = qkv_head_major(value.T, num_heads, tp, inverse=inverse).T
            else:
                out[key] = qkv_head_major(value, num_heads, tp, inverse=inverse)
    return out
