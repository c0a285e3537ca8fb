"""Read loading and device-friendly packing.

Host-side equivalent of ``ReadFile`` (reference ``src/Load.cpp``), re-shaped
for a fixed-shape machine:

* FASTA/FASTQ parsing keeps the reference's contract: extension must be
  ``fasta``/``fastq`` (``src/Load.cpp:23-30``), format is sniffed from the
  first character ``>``/``@`` (``src/Load.cpp:40-48``), multi-line FASTA and
  4-line FASTQ records are supported, reads shorter than k are dropped
  (``src/Load.cpp:59,86``), and ``all_bases`` accumulates kept read lengths
  for Bloom sizing.  Non-ACGT characters map to code 0 / 'A', matching the
  reference's ``unordered_map::operator[]`` default-insert behavior.

* Instead of a name->string hash map, reads are split into fixed-width
  overlapping CHUNKS and 2-bit packed into one ``[C, chunk_len/16] uint32``
  array (SURVEY.md §5 "long reads" bullet): chunk ``i`` of a read covers
  bases ``[i*stride, i*stride + chunk_len)`` with
  ``stride = chunk_len - k + 1``, so every k-mer start position of every
  read is OWNED by exactly one chunk and all bases a chunk's owned
  positions need are inside the chunk.  All downstream device code sees one
  uniform static shape regardless of read-length distribution.

Port of ``platanus3_tpu/io/reads.py``.  ``load_reads`` goes through the
C++ loader (``native/``, built with ``g++`` into ``build/native/`` on
first use) and raises if it cannot; ``use_native=False`` is the numpy
path, which stays the specification.  The arrays stay numpy; the
pipeline moves them to its device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Tuple

import numpy as np

from platanus3_tpu_torch.constants import BASES_PER_LANE
from platanus3_tpu_torch.ops.kmer import pack_bases_np

__all__ = ["ReadBatch", "load_reads", "parse_reads", "chunk_reads",
           "reads_from_strings"]

_CODE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


@dataclasses.dataclass
class ReadBatch:
    """Chunked, packed read set (the device-side ``ReadSet``).

    packed:   ``[C, chunk_len/16] uint32`` 2-bit packed bases
    valid_len:``[C] int32``  valid bases in chunk (rest is zero padding)
    read_id:  ``[C] int32``  read index of each chunk
    start:    ``[C] int32``  chunk's global start position within its read
    read_len: ``[C] int32``  total length of the chunk's read
    chunk_len: static chunk width (bases)
    k:        the large k the chunking stride was built for
    all_bases: total kept bases (Bloom sizing input, ``src/Load.cpp:62``)
    num_reads: number of kept reads
    """

    packed: np.ndarray
    valid_len: np.ndarray
    read_id: np.ndarray
    start: np.ndarray
    read_len: np.ndarray
    prev_base: np.ndarray   # [C] uint8 base before chunk start (4 = none)
    next_base: np.ndarray   # [C] uint8 base after chunk end (4 = none)
    chunk_len: int
    k: int
    all_bases: int
    num_reads: int

    @property
    def num_chunks(self) -> int:
        return self.packed.shape[0]

    @property
    def stride(self) -> int:
        return self.chunk_len - self.k + 1


def _parse_fasta(path: str) -> Iterable[Tuple[str, str]]:
    name, parts = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name, parts = line, []
            else:
                parts.append(line)
    if name is not None:
        yield name, "".join(parts)


def _parse_fastq(path: str) -> Iterable[Tuple[str, str]]:
    with open(path) as f:
        while True:
            name = f.readline()
            if not name:
                return
            seq = f.readline().rstrip("\n")
            f.readline()  # +
            f.readline()  # quality
            yield name.rstrip("\n"), seq


def _check_extension(path: str) -> None:
    ext = os.path.basename(path)[-5:]
    if ext not in ("fasta", "fastq"):
        raise ValueError(
            f"input must end in 'fasta' or 'fastq' (got {path!r})")


def parse_reads(path: str) -> List[str]:
    """Parse a FASTA/FASTQ file to a list of sequences.

    Enforces the reference's extension contract (``src/Load.cpp:23-30``) --
    but actually raises instead of setting a never-checked error code.
    """
    _check_extension(path)
    with open(path) as f:
        first = f.read(1)
    if first == ">":
        records = _parse_fasta(path)
    elif first == "@":
        records = _parse_fastq(path)
    else:
        raise ValueError(f"unrecognized read file format in {path!r}")
    return [seq for _, seq in records]


def reads_from_strings(seqs: List[str], k: int, chunk_len: int) -> ReadBatch:
    """Build a ReadBatch from sequence strings (drops reads < k)."""
    kept = [s for s in seqs if len(s) >= k]
    return chunk_reads(kept, k, chunk_len)


def load_reads(path: str, k: int, chunk_len: int,
               use_native: bool = True) -> ReadBatch:
    """Load + pack a read file (FASTA/FASTQ): through the C++ loader, or
    with ``use_native=False`` through the numpy parser.  The two give
    equal batches; the C++ loader raises rather than falling back."""
    if not use_native:
        return reads_from_strings(parse_reads(path), k, chunk_len)
    _check_extension(path)
    from platanus3_tpu_torch import native
    return native.load_reads_native(os.fspath(path), k, chunk_len)


def chunk_reads(seqs: List[str], k: int, chunk_len: int) -> ReadBatch:
    """Split reads into overlapping fixed-width chunks and 2-bit pack them.

    Requires ``chunk_len >= 2*k`` so that short-k-mer positions owned by a
    chunk never reference bases beyond it (see module docstring), and
    ``chunk_len % 16 == 0`` for lane packing.
    """
    assert chunk_len % BASES_PER_LANE == 0, "chunk_len must be multiple of 16"
    assert chunk_len >= 2 * k, f"chunk_len {chunk_len} < 2*k ({2*k})"
    stride = chunk_len - k + 1

    starts, rids, rlens, vlens = [], [], [], []
    total = 0
    for rid, s in enumerate(seqs):
        n = len(s)
        assert n >= k
        total += n
        nchunks = (n - k) // stride + 1
        for i in range(nchunks):
            st = i * stride
            starts.append(st)
            rids.append(rid)
            rlens.append(n)
            vlens.append(min(n - st, chunk_len))

    c = len(starts)
    bases = np.zeros((max(c, 1), chunk_len), dtype=np.uint8)
    prev_b = np.full(max(c, 1), 4, dtype=np.uint8)
    next_b = np.full(max(c, 1), 4, dtype=np.uint8)
    row = 0
    for rid, s in enumerate(seqs):
        codes = _CODE[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]
        n = len(s)
        nchunks = (n - k) // stride + 1
        for i in range(nchunks):
            st = i * stride
            v = min(n - st, chunk_len)
            bases[row, :v] = codes[st : st + v]
            if st > 0:
                prev_b[row] = codes[st - 1]
            if st + chunk_len < n:
                next_b[row] = codes[st + chunk_len]
            row += 1

    return ReadBatch(
        packed=pack_bases_np(bases),
        valid_len=np.asarray(vlens or [0], dtype=np.int32),
        read_id=np.asarray(rids or [0], dtype=np.int32),
        start=np.asarray(starts or [0], dtype=np.int32),
        read_len=np.asarray(rlens or [0], dtype=np.int32),
        prev_base=prev_b,
        next_base=next_b,
        chunk_len=chunk_len,
        k=k,
        all_bases=total,
        num_reads=len(seqs),
    )
