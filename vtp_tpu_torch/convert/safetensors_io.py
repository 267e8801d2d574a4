"""The ``.safetensors`` byte format in plain numpy.

A file is an 8-byte little-endian header length, a JSON header of
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (plus an
optional ``"__metadata__"`` of strings), then the raw little-endian
row-major data, the offsets counted from the end of the header. The
writer lays the file out as the ``safetensors`` package does: the metadata
first in the header (its keys sorted; the package's follow a hash map),
the tensors back to back by dtype (I64, F32, I32, BF16, F16: the package's
dtype order, descending), then by name, and the header padded with spaces
to a multiple of 8 bytes. A file of the same tensors with at most one
metadata key is then byte for byte the package's, and either side reads
the other's files.

F32, F16, BF16, I64 and I32 are read; numpy has no bfloat16, so a BF16
tensor comes back as fp32 (its bits shifted up by 16, which is exact).
F32, F16, I64 and I32 are written, and fp32 arrays named in ``bf16`` as
BF16 (rounded to nearest even, exact for values that came from bf16).
Zero-size tensors (the JAX package's ``__none__`` markers) are read and
written.
"""

from __future__ import annotations

import json
import struct
from typing import Collection, Dict, Optional, Tuple

import numpy as np

_READ = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2"),
         "I64": np.dtype("<i8"), "I32": np.dtype("<i4")}
_WRITE = {np.dtype("float32"): "F32", np.dtype("float16"): "F16", np.dtype("int64"): "I64",
          np.dtype("int32"): "I32"}
# the layout order of the tags written: the safetensors package's, by dtype
_ORDER = {tag: i for i, tag in enumerate(("I64", "F32", "I32", "BF16", "F16"))}
_MAX_HEADER = 100 * 1024 * 1024


def read_safetensors_header(path: str) -> Tuple[int, Dict]:
    """(header length, the JSON header: ``{name: {"dtype", "shape",
    "data_offsets"}}`` and any ``"__metadata__"``) of a file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes is not a safetensors header")
        return n, json.loads(f.read(n))


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of the file, as numpy arrays (BF16 as fp32)."""
    n, header = read_safetensors_header(path)
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
    """Write float32, float16, int64 or int32 numpy arrays as one
    ``.safetensors`` file; the fp32 arrays named in ``bf16`` are written as
    BF16."""
    tagged = []
    for name, value in tensors.items():
        arr = np.asarray(value)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")  # (np.ascontiguousarray would make a 0-d array 1-d)
        dtype = arr.dtype.newbyteorder("=")
        if dtype not in _WRITE or (name in bf16 and dtype != np.float32):
            raise TypeError(f"{name}: dtype {arr.dtype}; only float32, float16, int64 and int32 "
                            f"are written, and BF16 from float32")
        if name in bf16:
            arr, tag = _to_bf16_bits(arr).astype("<u2"), "BF16"
        else:
            arr, tag = arr.astype(dtype.newbyteorder("<"), copy=False), _WRITE[dtype]
        tagged.append((_ORDER[tag], name, tag, arr))
    header = {"__metadata__": dict(sorted(metadata.items()))} if metadata else {}
    offset, arrays = 0, []
    for _, name, tag, arr in sorted(tagged, key=lambda t: t[:2]):
        header[name] = {"dtype": tag, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for arr in arrays:
            f.write(arr.data)
