"""Vectorized k-mer hashing, bit-equal to ``platanus3_tpu/ops/hashing.py``.

Murmur3-32-style mixing over the ``uint32`` lanes of each k-mer.  The
JAX package runs it in wrapping ``uint32`` arithmetic; here every value
is an ``int64`` holding a ``uint32``, and each multiply is masked back
to 32 bits (the low 32 bits of a wrapped int64 product are exact).
Bloom filter words, and through false positives the Bloom-mode graph,
depend on every bit of these values.

The CUDA kernels compute the same hash in native ``uint32`` arithmetic
(``csrc/hash.cuh``); ``hash_init`` gives them the per-seed start value.
"""

from __future__ import annotations

import torch

from platanus3_tpu_torch.constants import num_lanes
from platanus3_tpu_torch.ops.kmer import MASK32

__all__ = ["hash_kmers", "double_hash", "probe_positions",
           "probe_positions_wide", "hash_init", "SEED_H1", "SEED_H2",
           "SEED_H3", "SEED_H4"]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35

SEED_H1 = 0x8C5FB1F7
SEED_H2 = 0x27D4EB2F
# The second double-hash pair of the wide (>= 2^32-bit) Bloom positions.
SEED_H3 = 0x94D049BB
SEED_H4 = 0xBF58476D


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * _MIX1) & MASK32
    h = h ^ (h >> 13)
    h = (h * _MIX2) & MASK32
    return h ^ (h >> 16)


def hash_init(k: int, seed: int) -> int:
    """Start value of the murmur body for k-mer length ``k``."""
    return (seed ^ (k * 0x9E3779B9)) & MASK32


def hash_kmers(kmers: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """Hash ``[..., L]`` lane tensors to ``[...]`` int64 (uint32 values)."""
    l = num_lanes(k)
    assert kmers.shape[-1] == l
    h = torch.full(kmers.shape[:-1], hash_init(k, seed), dtype=torch.int64,
                   device=kmers.device)
    for j in range(l):
        kx = (kmers[..., j] * _C1) & MASK32
        kx = (_rotl32(kx, 15) * _C2) & MASK32
        h = h ^ kx
        h = (_rotl32(h, 13) * 5 + 0xE6546B64) & MASK32
    return _fmix32(h ^ (4 * l))


def double_hash(kmers: torch.Tensor, k: int):
    """Two independent hashes ``(h1, h2)``; ``h2`` forced odd so the probe
    sequence has full period in a power-of-two filter."""
    h1 = hash_kmers(kmers, k, seed=SEED_H1)
    h2 = hash_kmers(kmers, k, seed=SEED_H2) | 1
    return h1, h2


def probe_positions(h1: torch.Tensor, h2: torch.Tensor, num_hashes: int,
                    log2_bits: int) -> torch.Tensor:
    """Bloom probe bit positions ``[num_hashes, ...]``:
    ``(h1 + n*h2) mod 2^log2_bits`` (the reference's ``nthHash``)."""
    n = torch.arange(num_hashes, dtype=torch.int64, device=h1.device)
    n = n.reshape((num_hashes,) + (1,) * h1.dim())
    return (h1[None] + n * h2[None]) & ((1 << log2_bits) - 1)


def probe_positions_wide(kmers: torch.Tensor, k: int, num_hashes: int,
                         log2_bits: int, lo_bits: int = 32):
    """Probe positions of a filter of ``2^log2_bits >= 2^lo_bits`` bits as
    ``(hi, lo)``, each ``[num_hashes, ...]``; the position is
    ``hi * 2^lo_bits + lo``.  ``lo`` follows the double hash of
    :func:`probe_positions`, ``hi`` a second pair seeded with ``SEED_H3``
    and ``SEED_H4``.  ``lo_bits`` is 32 in production; tests shrink it to
    drive the path on a small filter."""
    assert log2_bits >= lo_bits
    h1, h2 = double_hash(kmers, k)
    h3 = hash_kmers(kmers, k, seed=SEED_H3)
    h4 = hash_kmers(kmers, k, seed=SEED_H4)
    n = torch.arange(num_hashes, dtype=torch.int64, device=h1.device)
    n = n.reshape((num_hashes,) + (1,) * h1.dim())
    lo = (h1[None] + n * h2[None]) & ((1 << lo_bits) - 1)
    hi = (h3[None] + n * h4[None]) & ((1 << (log2_bits - lo_bits)) - 1)
    return hi, lo
