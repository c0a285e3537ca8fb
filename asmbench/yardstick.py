"""Peaks of the device and the least bytes of the port's kernels.

The bytes follow the rule of the port's kernel table: each input byte
read once and each output byte written once, counting only what these
inputs need (the lanes of the rows a mask lets in, not of every row).
"""

from __future__ import annotations

import numpy as np

__all__ = ["PEAKS", "peaks_of", "graph_cap", "num_chunks",
           "bloom_set_bits_bytes"]

# Published peaks (NVIDIA's data sheet, SXM part, at its 700 W limit).
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12}}


def peaks_of(kind: str):
    """The peaks of a device by its name, or None for one not listed."""
    for part, peaks in PEAKS.items():
        if part in kind:
            return peaks
    return None


def graph_cap(n: int) -> int:
    """Rows of a node table of ``n`` nodes as the single-shot path pads
    it: a power of two up to 2^22, above that a multiple of 2^20."""
    p = max(8, 1 << max(0, int(n - 1).bit_length()))
    if p <= 1 << 22:
        return p
    return min(p, -(-int(n) // (1 << 20)) * (1 << 20))


def num_chunks(offs: np.ndarray, k: int, chunk_len: int) -> int:
    """Chunks of ``chunk_len`` bases the reads split into (each k-mer start
    owned by one chunk, so chunks step by ``chunk_len - k + 1``)."""
    lens = np.diff(offs)
    lens = lens[lens >= k]
    return int(((lens - k) // (chunk_len - k + 1) + 1).sum())


def bloom_set_bits_bytes(params: dict, launches: int, solid_nodes: int,
                         solid_positions: int, chunks: int) -> int:
    """Least bytes of one job's ``bloom_set_bits`` launches: the mask of
    every row (one byte each), the lanes of the rows it lets in (8 bytes
    a 16-base lane), and the filter's words read and written once a
    launch.  Single shot inserts the padded node table once; streaming
    inserts every solid position of each slice."""
    k = params["k"]
    lanes = -(-k // 16)
    if params.get("streaming"):
        rows = chunks * (params["chunk_len"] - k + 1)
        masked = solid_positions
    else:
        rows = graph_cap(solid_nodes)
        masked = solid_nodes
    return rows + masked * lanes * 8 + launches * 2 * params["filter_bits"] // 8
