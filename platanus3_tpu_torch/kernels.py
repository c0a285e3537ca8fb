"""Build and load the port's CUDA kernels.

Each ``.cu`` source in ``csrc/`` is compiled at first use by its own
``nvcc``, all started together, and the objects are linked into one
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so the build takes seconds).  The library goes to
``build/kernels/`` beside the package, named by a digest of every source
and header in ``csrc/``, so an edited file is rebuilt and never served
stale.

Nothing here runs at import: the CPU tests import every module, and the
CPU machines have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "library_path", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib = None


def _sources():
    """The ``.cu`` files, each compiled on its own."""
    return sorted(_CSRC.glob("*.cu"))


def _digested():
    """Every file a build reads: the sources and the headers they
    include."""
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _digested():
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


def _check(cmd, proc, out: str, err: str) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}{err}")


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs, jobs = [], []
        for src in _sources():
            obj = Path(tmpdir) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(str(obj))
        for cmd, proc in jobs:
            _check(cmd, proc, *proc.communicate())
        tmp = Path(tmpdir) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, proc, proc.stdout, proc.stderr)
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
    vp, i, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_longlong)
    lib.bloom_set_bits.argtypes = [vp, vp, ll, i, u, u, i, u, vp, vp]
    lib.bloom_set_bits.restype = i
    lib.bloom_blocked_set_bits.argtypes = [vp, vp, ll, i, u, u, i, i, vp, vp]
    lib.bloom_blocked_set_bits.restype = i
    lib.oa_count_insert.argtypes = [vp, vp, ll, i, u, i, vp, vp, vp, vp, vp]
    lib.oa_count_insert.restype = i
    _lib = lib
    return lib
