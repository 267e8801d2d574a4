"""Resolution bucketing for variable-size inputs (a numpy copy of
``vtp_tpu/utils/buckets.py``: ``pick_bucket`` :21, ``snap_to_bucket`` :29).

Snapping requests to a small set of patch-aligned square sizes keeps the
shapes a server sees few, so batches of mixed sizes coalesce and every
shape-keyed choice (a cuBLAS algorithm, the attention kernels' tiles) is
made once. RoPE takes any grid (the coordinates come from the runtime H
and W), so bucketed inputs stay semantically correct.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (224, 256, 384, 512)


def pick_bucket(size: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= size, else the largest bucket."""
    for b in sorted(buckets):
        if b >= size:
            return b
    return max(buckets)


def snap_to_bucket(
    images: np.ndarray,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    patch: int = 16,
    pad_value: float = 0.0,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """(B, C, H, W) -> center-padded/cropped to a square patch-aligned
    bucket. Returns (snapped, (orig_h, orig_w)) so outputs can be
    cropped back. Images larger than every bucket are center-cropped.
    """
    B, C, H, W = images.shape
    target = pick_bucket(max(H, W), buckets)
    if target % patch:
        raise ValueError(f"bucket {target} not divisible by patch {patch}")

    def axis_fit(x, axis, size):
        cur = x.shape[axis]
        if cur > size:  # center crop
            lo = (cur - size) // 2
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(lo, lo + size)
            return x[tuple(sl)]
        if cur < size:  # center pad
            pad = [(0, 0)] * x.ndim
            lo = (size - cur) // 2
            pad[axis] = (lo, size - cur - lo)
            return np.pad(x, pad, constant_values=pad_value)
        return x

    out = axis_fit(axis_fit(images, 2, target), 3, target)
    return out, (H, W)
