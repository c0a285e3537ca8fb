"""Native (C++) read loader, bound with ctypes.

Port of ``platanus3_tpu/native/``.  ``packer.cpp`` is compiled by
``g++ -O3 -shared -fPIC -pthread`` at first use into ``build/native/``
beside the package, named by a digest of the source and the flags (as
``kernels.py`` names the CUDA library), so an edited source is rebuilt
and never served stale.

Unlike the JAX package this loader never falls back: a failed build, a
library that does not load, or a file the parser cannot open raises.
``io/reads.load_reads(use_native=False)`` is the numpy path, which stays
the specification; ``tests/test_torch_native.py`` holds the two (and the
JAX package's loader) equal.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["load_reads_native", "get_lib", "library_path", "CXX_FLAGS"]

_SRC = Path(__file__).resolve().parent / "packer.cpp"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"libp3native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        tmp = Path(tmpdir) / out.name
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except OSError as e:
            raise RuntimeError(f"native loader: cannot run g++: {e}")
        if proc.returncode != 0:
            raise RuntimeError(f"native loader build failed "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    lib.p3_open.restype = ctypes.c_void_p
    lib.p3_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    for f in ("p3_num_chunks", "p3_num_reads", "p3_all_bases"):
        getattr(lib, f).restype = ctypes.c_uint64
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.p3_fill.restype = None
    lib.p3_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int]
    lib.p3_close.restype = None
    lib.p3_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def load_reads_native(path: str, k: int, chunk_len: int, threads: int = 8):
    """Parse and pack a FASTA/FASTQ file; returns the port's
    ``io.reads.ReadBatch``.  Raises ``OSError`` when the parser cannot
    open the file or finds no record marker at its start."""
    from platanus3_tpu_torch.io.reads import ReadBatch

    lib = get_lib()
    h = lib.p3_open(os.fsencode(path), k, chunk_len)
    if not h:
        raise OSError(f"native loader could not read {path!r} (missing, "
                      f"empty, or not starting with '>' or '@')")
    try:
        c = int(lib.p3_num_chunks(h))
        num_reads = int(lib.p3_num_reads(h))
        all_bases = int(lib.p3_all_bases(h))
        if c == 0:
            return ReadBatch(
                packed=np.zeros((1, chunk_len // 16), np.uint32),
                valid_len=np.zeros(1, np.int32),
                read_id=np.zeros(1, np.int32),
                start=np.zeros(1, np.int32),
                read_len=np.zeros(1, np.int32),
                prev_base=np.full(1, 4, np.uint8),
                next_base=np.full(1, 4, np.uint8),
                chunk_len=chunk_len, k=k, all_bases=all_bases,
                num_reads=num_reads)
        packed = np.empty((c, chunk_len // 16), np.uint32)
        valid_len = np.empty(c, np.int32)
        read_id = np.empty(c, np.int32)
        start = np.empty(c, np.int32)
        read_len = np.empty(c, np.int32)
        prev_base = np.empty(c, np.uint8)
        next_base = np.empty(c, np.uint8)

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        lib.p3_fill(h, ptr(packed), ptr(valid_len), ptr(read_id), ptr(start),
                    ptr(read_len), ptr(prev_base), ptr(next_base), threads)
        return ReadBatch(
            packed=packed, valid_len=valid_len, read_id=read_id, start=start,
            read_len=read_len, prev_base=prev_base, next_base=next_base,
            chunk_len=chunk_len, k=k, all_bases=all_bases,
            num_reads=num_reads)
    finally:
        lib.p3_close(h)
