"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every source under ``csrc/`` is compiled for ``sm_90a`` into one shared
library with a plain C interface (no PyTorch header, no
``torch.utils.cpp_extension``): a build takes seconds. With several
sources, one ``nvcc -c`` per source runs at once and a last ``nvcc
-shared`` links the objects. The library goes
into ``vtp_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, so a stale library is never loaded; it is written
under a temporary name and moved into place, so a build cut short
leaves nothing that a later run would load. ptxas reports each kernel's
registers, shared memory and spills (``-Xptxas -v``); the report is kept
beside the library, under the same hash, and ``ptxas_report`` reads it.

The first kernel launch on a CUDA tensor builds; nothing is built when
the package is imported or when a CPU tensor takes the plain path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_FLAGS = COMPILE_FLAGS + ["-shared"]
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin")


def library_path(srcs: Optional[List[Path]] = None) -> Path:
    """Where the library built from ``srcs`` lives: the name carries a
    hash of every source (``*.cu`` and ``*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(srcs if srcs is not None else sources()) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvtp_kernels_{h.hexdigest()[:16]}.so"


def nvcc_command(out: Path, srcs: List[Path]) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), *map(str, srcs)]


def _run(cmds: List[List[str]]) -> str:
    """Run the commands at once; raise with nvcc's output if any fails,
    else return their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed, said = [], []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{err}{out}")
        said.append(err + out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(said)


def _compile(out: Path, srcs: List[Path]) -> str:
    """Build the library ``out``; return ptxas's report."""
    if len(srcs) == 1:
        return _run([nvcc_command(out, srcs)])
    objs = [out.with_name(f"{out.stem}.{src.stem}.o") for src in srcs]
    try:
        report = _run([[nvcc_path(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                       for obj, src in zip(objs, srcs)])
        _run([[nvcc_path(), *NVCC_FLAGS, "-o", str(out), *map(str, objs)]])
        return report
    finally:
        for obj in objs:
            if obj.exists():
                obj.unlink()


def report_path(lib: Path) -> Path:
    """Where ptxas's report of the library ``lib`` is kept."""
    return lib.with_suffix(".ptxas.txt")


def build() -> Path:
    """Compile the sources unless a library of the same hash exists;
    return its path. Raises with nvcc's output if the build fails. The
    report is moved into place before the library, so a library that
    exists has its report."""
    srcs = sources()
    lib = library_path(srcs)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    tmp_report = tmp.with_suffix(".txt")
    try:
        tmp_report.write_text(_compile(tmp, srcs))
        os.replace(tmp_report, report_path(lib))
        os.replace(tmp, lib)
    finally:
        for p in (tmp, tmp_report):
            if p.exists():
                p.unlink()
    return lib


def ptxas_report() -> str:
    """ptxas's report (registers, shared memory, spills of each kernel) of
    the library that the sources build; raises if there is none."""
    path = report_path(library_path())
    if not path.exists():
        raise RuntimeError(f"no ptxas report at {path}: build the library first")
    return path.read_text()


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
