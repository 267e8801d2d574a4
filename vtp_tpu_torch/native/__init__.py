"""ctypes bindings for the native ingest library (port of ``vtp_tpu/native``).

``ingest.cpp`` (the port's own copy) decodes JPEG and PNG files and
resamples them as PIL does, in a C++ thread pool, straight into a float32
NCHW buffer. It is built with ``g++`` at first use, never at import, into
``vtp_tpu_torch/_build/`` under a name that carries a hash of the source,
the flags and the host CPU (the build uses ``-march=native`` and the build
directory may be shared by machines with different CPUs). The build is
written under a temporary name and moved into place. Where it cannot be
built (no compiler, no libjpeg or libpng development files),
``native_available()`` is False, ``build_error()`` says why and
``ingest_batch`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

SOURCE = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-ljpeg", "-lpng", "-lpthread"]
BUILD_TIMEOUT_S = 180

MODE_ADM_CROP = 0
MODE_NAIVE_RESIZE = 1
MODE_RESIZE_CROP = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _cpu_identity() -> str:
    """The host CPU's model and feature flags (what ``-march=native`` reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags", "Features"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine() + platform.processor()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_identity().encode())
    return BUILD_DIR / f"libvtp_ingest_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the library to ``out``; None, or what went wrong."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"build failed: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"build failed: {proc.stderr[-2000:]}"
    os.replace(tmp, out)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build_error = _build(path)
            if _build_error:
                return None
        lib = ctypes.CDLL(str(path))
        lib.vtp_ingest_batch.restype = ctypes.c_int
        lib.vtp_ingest_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library is built (building it now if need be) and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable, or None."""
    _load()
    return _build_error


def ingest_batch(
    paths: Sequence[str],
    target: int,
    *,
    mode: int = MODE_ADM_CROP,
    aux: int = 0,
    mean: Sequence[float] = (0.485, 0.456, 0.406),
    std: Sequence[float] = (0.229, 0.224, 0.225),
    flips: Optional[Sequence[int]] = None,
    num_threads: int = 0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode and preprocess image files into a (N, 3, T, T) fp32 CPU tensor.

    mode: MODE_ADM_CROP (the reconstruction protocol), MODE_NAIVE_RESIZE
    (zero-shot), MODE_RESIZE_CROP with aux = the short side's resize
    (linear-probe eval). A file that fails to decode gives a zero row.
    ``out``, when given, is a contiguous fp32 CPU tensor of that shape
    (pinned, say) and is filled in place.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_build_error}")
    n = len(paths)
    shape = (n, 3, target, target)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32)
    if (tuple(out.shape) != shape or out.dtype != torch.float32 or out.device.type != "cpu"
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous fp32 CPU tensor of shape {shape}")
    if flips is not None and len(flips) != n:
        raise ValueError(f"{len(flips)} flips for {n} paths")
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    mean_arr = (ctypes.c_float * 3)(*[float(m) for m in mean])
    std_arr = (ctypes.c_float * 3)(*[float(s) for s in std])
    flips_arr = (ctypes.c_int * n)(*[int(f) for f in flips]) if flips is not None else None
    nt = num_threads or min(os.cpu_count() or 8, 16)
    lib.vtp_ingest_batch(c_paths, n, target, aux, mode, mean_arr, std_arr, flips_arr,
                         ctypes.cast(out.data_ptr(), ctypes.POINTER(ctypes.c_float)), nt)
    return out
