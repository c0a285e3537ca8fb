"""Vectorized k-mer hashing, bit-equal to ``platanus3_tpu/ops/hashing.py``.

Murmur3-32-style mixing over the ``uint32`` lanes of each k-mer.  The
JAX package runs it in wrapping ``uint32`` arithmetic; here every value
is an ``int64`` holding a ``uint32``, and each multiply is masked back
to 32 bits (the low 32 bits of a wrapped int64 product are exact).
Bloom filter words, and through false positives the Bloom-mode graph,
depend on every bit of these values.

The CUDA kernels compute the same hash in native ``uint32`` arithmetic
(``csrc/hash.cuh``); ``hash_init`` gives them the per-seed start value.

Filters of 2^32 bits and more take their probes from a 64-bit hash
instead (``wide_probe_pair``), where the port departs from the JAX
package.  Murmur seeded only through its start value is a poor pair of
hashes: after the first lane the two seeds' states differ by a function
of that lane alone, and the later lanes are XORed into both alike.  At
k = 25 (a first lane of 18 bits) that difference takes 244,579 values
over the 2^18 first lanes, so 21,030 pairs of first lanes share it where
8 would by chance, and every k-mer with such a first lane has a twin, a
k-mer with the other first lane and the same ``(h1, h2)``: the same
probes below 2^32 bits, and at 2^33 bits the same JAX wide probes with
chance 1/4 (their high bit follows the parities of two more murmurs).
The wide hash folds the lanes, two to a 64-bit word, into
``fmix64`` (murmur3's 64-bit finaliser, a bijection): at k <= 32 a key
is one word, so two k-mers never share a hash, and their probe pairs
agree only by chance.
"""

from __future__ import annotations

import torch

from platanus3_tpu_torch.constants import num_lanes
from platanus3_tpu_torch.ops.kmer import MASK32

__all__ = ["hash_kmers", "double_hash", "probe_positions", "hash_init",
           "hash64_kmers", "fmix64", "wide_seeds", "wide_probe_pair",
           "SEED_H1", "SEED_H2", "SEED_H3", "SEED_H4"]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35

SEED_H1 = 0x8C5FB1F7
SEED_H2 = 0x27D4EB2F
# With SEED_H1 and SEED_H2, the halves of the wide hash's 64-bit seeds.
SEED_H3 = 0x94D049BB
SEED_H4 = 0xBF58476D

# murmur3's fmix64 multipliers, as the int64 holding their bit pattern.
_F64_1 = 0xFF51AFD7ED558CCD - (1 << 64)
_F64_2 = 0xC4CEB9FE1A85EC53 - (1 << 64)
_LOW31 = (1 << 31) - 1


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


def fmix64(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 64-bit finaliser on int64 tensors holding ``uint64`` bit
    patterns (products wrap modulo 2^64; ``>> 33`` is made logical by its
    mask)."""
    h = h ^ ((h >> 33) & _LOW31)
    h = h * _F64_1
    h = h ^ ((h >> 33) & _LOW31)
    h = h * _F64_2
    return h ^ ((h >> 33) & _LOW31)


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def wide_seeds(k: int) -> tuple[int, int]:
    """The two 64-bit seeds of the wide hash, as int64 values:
    ``hash_init`` of SEED_H1 and SEED_H3, then of SEED_H2 and SEED_H4,
    high half first."""
    return tuple(_signed64((hash_init(k, a) << 32) | hash_init(k, b))
                 for a, b in ((SEED_H1, SEED_H3), (SEED_H2, SEED_H4)))


def hash64_kmers(kmers: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """64-bit hash ``[...]`` (int64 bit patterns) of ``[..., L]`` lanes:
    the lanes packed into 64-bit words as ``count.pack_keys`` packs them
    (an odd L puts lane 0 alone in the first word), each folded in as
    ``h = fmix64(h ^ word)`` from ``h = seed``."""
    l = num_lanes(k)
    assert kmers.shape[-1] == l
    h = torch.full(kmers.shape[:-1], seed, dtype=torch.int64,
                   device=kmers.device)
    first = l % 2
    if first:
        h = fmix64(h ^ kmers[..., 0])
    for j in range(first, l, 2):
        h = fmix64(h ^ ((kmers[..., j] << 32) | kmers[..., j + 1]))
    return h


def wide_probe_pair(kmers: torch.Tensor, k: int, log2_bits: int):
    """``(start, step)`` of the probes of a ``2^log2_bits``-bit filter from
    the wide hash: probe ``n`` is ``(start + n*step) mod 2^log2_bits``
    (:func:`probe_positions`), both reduced modulo ``2^log2_bits``, the
    step odd."""
    s1, s2 = wide_seeds(k)
    mask = (1 << log2_bits) - 1
    return (hash64_kmers(kmers, k, s1) & mask,
            (hash64_kmers(kmers, k, s2) | 1) & mask)

