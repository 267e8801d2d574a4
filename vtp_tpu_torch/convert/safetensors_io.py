"""The ``.safetensors`` byte format in plain numpy.

A file is an 8-byte little-endian header length, a JSON header of
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus an
optional ``"__metadata__"`` of strings), then the raw little-endian
row-major data, the offsets counted from the end of the header. The
writer pads the header with spaces to a multiple of 8 bytes and lays the
tensors out back to back in name order, as the ``safetensors`` package
does, so either side reads the other's files.

F32, F16 and BF16 are read; numpy has no bfloat16, so a BF16 tensor comes
back as fp32 (its bits shifted up by 16, which is exact). F32 and F16 are
written, and fp32 arrays named in ``bf16`` as BF16 (rounded to nearest
even, exact for values that came from bf16). Zero-size tensors (the JAX
package's ``__none__`` markers) are read and written.
"""

from __future__ import annotations

import json
import struct
from typing import Collection, Dict, Optional

import numpy as np

_READ = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2")}
_WRITE = {np.dtype("float32"): "F32", np.dtype("float16"): "F16"}
_MAX_HEADER = 100 * 1024 * 1024


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the file, as numpy arrays (BF16 as fp32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes is not a safetensors header")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    if not header:
        return {}
    # a file whose tensors are all empty has no data to map
    has_data = any(info["data_offsets"][1] > info["data_offsets"][0] for info in header.values())
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n) if has_data else None
    out = {}
    for name, info in header.items():
        dtype = _READ.get(info["dtype"])
        if dtype is None:
            raise NotImplementedError(f"{path}: {name} has dtype {info['dtype']}; "
                                      f"only {sorted(_READ)} are read")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end - begin != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name} holds {end - begin} bytes, not {shape} {info['dtype']}")
        if end == begin:
            arr = np.zeros(shape, dtype=dtype)
        else:
            arr = np.frombuffer(data[begin:end], dtype=dtype).reshape(shape)
        if info["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = np.array(arr, dtype=arr.dtype.newbyteorder("="))
    return out


def _to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 -> the bits of bf16 (uint16), rounded to nearest even."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    rounded = bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))
    return np.where(np.isnan(x), np.uint32(0x7FC00000), rounded).astype(np.uint32) >> 16


def save_safetensors(path: str, tensors: Dict[str, np.ndarray],
                     metadata: Optional[Dict[str, str]] = None,
                     bf16: Collection[str] = ()) -> None:
    """Write fp32 or fp16 numpy arrays as one ``.safetensors`` file; the
    fp32 arrays named in ``bf16`` are written as BF16."""
    header, offset, arrays = {}, 0, []
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")  # (np.ascontiguousarray would make a 0-d array 1-d)
        if arr.dtype not in _WRITE or (name in bf16 and arr.dtype != np.float32):
            raise TypeError(f"{name}: dtype {arr.dtype}; only float32 and float16 are written, "
                            f"and BF16 from float32")
        if name in bf16:
            arr, tag = _to_bf16_bits(arr).astype("<u2"), "BF16"
        else:
            arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
            tag = _WRITE[arr.dtype.newbyteorder("=")]
        header[name] = {"dtype": tag, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for arr in arrays:
            f.write(arr.data)
