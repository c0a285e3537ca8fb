"""Build and load the port's CUDA kernels.

The ``.cu`` sources in ``csrc/`` are compiled at first use with ``nvcc``
into one shared library with a plain C interface, which is loaded with
``ctypes`` (no PyTorch headers, so the build takes seconds).  The library
goes to ``build/kernels/`` beside the package, named by a digest of the
sources, so an edited source is rebuilt and never served stale.

Nothing here runs at import: the CPU tests import every module, and the
CPU machines have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load_library", "library_path", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libp3kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources()]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load_library():
    """Build (if needed) and load the kernel library; returns the
    ``ctypes.CDLL`` with every entry point's signature declared."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.bloom_set_bits.argtypes = [vp, vp, ctypes.c_longlong, i, u, u, i, u,
                                   vp, vp]
    lib.bloom_set_bits.restype = i
    _lib = lib
    return lib
