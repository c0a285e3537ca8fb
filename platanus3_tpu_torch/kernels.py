"""Build and load the port's CUDA kernels.

Each ``.cu`` source in ``csrc/`` is compiled at first use by its own
``nvcc``, all started together, and the objects are linked into one
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so the build takes seconds).  The library goes to
``build/kernels/`` beside the package, named by a digest of every source
and header in ``csrc/``, so an edited file is rebuilt and never served
stale.

The three partitioning kernels run as several passes
(``bloom_set_bits``, ``oa_count_insert``, ``bloom_blocked_set_bits``) and
are launched by a generator in their wrapper's module that yields after
each pass; ``run_passes`` runs one to its end, and ``chip_smoke.py`` steps
through one to time each pass.  They partition their items in two levels
(``csrc/partition.cuh``); ``partition_levels``, ``partition_ctas`` and
``partition_offsets`` size the passes and scan between them.
``slice_kmers`` (``ops/slice_kmers.py``) and ``coverage_tally``
(``ops/coverage_tally.py``) are one launch each, on the chunk body of
``csrc/chunk.cuh``.

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

import torch

__all__ = ["load_library", "library_path", "NVCC_FLAGS", "run_passes",
           "launch", "partition_levels", "partition_ctas",
           "partition_offsets"]

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
    for name, args in (
            ("bloom_partition_count", [vp, vp, ll, i, u, u, u, u, i, i, i,
                                       i, i, i, i, vp, vp]),
            ("bloom_partition_scatter", [vp, vp, ll, i, u, u, u, u, i, i, i,
                                         i, i, i, i, vp, vp, vp]),
            ("bloom_partition_refine", [vp, vp, i, i, i, vp, vp, vp]),
            ("bloom_region_or", [vp, vp, i, i, vp, vp, vp]),
            ("bloom_blocked_partition_count", [vp, vp, ll, i, u, u, i, i, i,
                                               vp, vp]),
            ("bloom_blocked_partition_scatter", [vp, vp, ll, i, u, u, i, i,
                                                 i, vp, vp, vp]),
            ("bloom_blocked_partition_refine", [vp, vp, i, i, vp, vp, vp]),
            ("bloom_block_build", [vp, vp, i, i, vp, vp]),
            ("oa_partition_count", [vp, vp, ll, i, u, i, i, i, vp, vp, vp]),
            ("oa_partition_scatter", [vp, vp, ll, i, u, i, i, i, vp, vp,
                                      vp]),
            ("oa_partition_refine", [vp, vp, vp, i, u, i, i, vp, vp, vp]),
            ("oa_block_insert", [vp, vp, vp, i, u, i, vp, vp, vp, vp]),
            ("slice_kmers", [i, vp, vp, vp, vp, vp, ll, i, i, i, i, i, ll, u,
                             vp, vp, vp, vp, vp, vp, vp]),
            ("coverage_tally", [vp, vp, vp, vp, vp, vp, vp, vp, vp, i, vp,
                                vp, vp, ll, i, i, vp])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    _lib = lib
    return lib


def run_passes(passes):
    """Run a wrapper's generator of kernel passes to its end and return
    its result.  Each ``yield`` follows one pass's launch, so a caller
    that steps through the generator itself can time every pass."""
    try:
        while True:
            next(passes)
    except StopIteration as done:
        return done.value


def launch(device, fn, *args) -> None:
    """Call the library's ``fn`` with ``args`` and the current stream of
    ``device``; raise if the launch returned a CUDA error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


# The partition's first level has at most 2^8 top buckets, so that each
# CTA's 256 open write ranges stay in L2 (csrc/partition.cuh).
MAX_TOP_LOG2 = 8


def partition_levels(buckets_log2: int) -> tuple[int, int]:
    """``(top_log2, sub_log2)``: 2^buckets_log2 buckets split into top
    buckets of the first level and sub-buckets of the refine."""
    top = min(buckets_log2, MAX_TOP_LOG2)
    return top, buckets_log2 - top


def partition_ctas(device) -> int:
    """CTAs of the count and scatter passes: two an SM."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def partition_offsets(hist: torch.Tensor):
    """The scan between the count and the scatter.  ``hist [C, tops]``
    holds each CTA's items per top bucket; returns ``offsets [C, tops]
    int64``, where each CTA's items of each top bucket start in the
    scratch (top buckets in order, CTAs in order inside each), and
    ``top_start [tops + 1] int64``, where each top bucket starts, then
    the total."""
    ctas, tops = hist.shape
    flat = hist.T.reshape(-1).to(torch.int64)
    start = torch.zeros((flat.shape[0] + 1,), dtype=torch.int64,
                        device=hist.device)
    start[1:] = flat.cumsum(0)
    offsets = start[:-1].reshape(tops, ctas).T.contiguous()
    return offsets, torch.cat([start[:-1:ctas], start[-1:]])
