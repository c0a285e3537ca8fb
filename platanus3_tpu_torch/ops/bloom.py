"""Packed Bloom filter over device tensors.

Port of ``platanus3_tpu/ops/bloom.py`` for filters of up to 2^35 bits.
The filter is ``2^log2_bits / 32`` packed 32-bit words held in an
``int32`` tensor (the ``uint32`` bit patterns): bit ``p`` is bit
``p & 31`` of word ``p >> 5``.  Membership semantics are the reference's:
``num_hashes`` double-hash probes, no false negatives, AND over probes
(``BF::possiblyContains``, ``src/bloomfilter.cpp:76-86``).  A probe is
``(start + n*step) mod 2^log2_bits``: below 2^32 bits ``(start, step)``
is the reference's double hash ``(h1, h2)``, as in the JAX package; from
2^32 bits on (``WIDE_LOG2_BITS``) it comes from a 64-bit hash of the
whole k-mer (``hashing.wide_probe_pair``), where the JAX package places
the probes at ``hi * 2^32 + lo`` from the same ``(h1, h2)``.  The port
departs there because that pair gives some k-mers a twin with the same
probes (``hashing``): a chromosome's node table in 2^33 bits then held
false neighbours far more often than an ideal filter's rate at its fill.
Word indices are int64 (2^35 bits are 2^30 words).

``bloom_add`` is the wrapper of the hand-written CUDA kernel
``bloom_set_bits`` (``csrc/bloom.cu``), which replaces the Pallas kernel
``platanus3_tpu/ops/bloom_pallas.py::_set_bits_kernel``.  On a CUDA
tensor it launches the kernel; on a CPU tensor it runs the plain PyTorch
version, ``bloom_add_plain``, which mirrors the JAX build (probe
positions -> sort -> dedup -> scatter-add of the bit values).  The kernel
partitions the probes by filter region (``region_layout``) in two levels
(count, scatter and refine passes, with scratch of two ``rows *
num_hashes`` int32 arrays; ``kernels.partition_levels``), then ORs each
region in one CTA's shared memory, reading the old words and writing
every word of a new tensor, so the input filter is neither copied nor
modified.  It hashes every lane of a row, at any k.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from platanus3_tpu_torch import kernels
from platanus3_tpu_torch.ops import hashing
from platanus3_tpu_torch.ops.kmer import MASK32

__all__ = ["BloomFilter", "make_bloom", "bloom_add", "bloom_add_plain",
           "bloom_query", "log2_ceil", "words_to_signed", "region_layout",
           "bloom_add_passes", "bloom_merge", "probe_pair", "popcount"]

# Largest filter, as the JAX package's make_bloom: 2^30 words, 4 GiB.
MAX_LOG2_BITS = 35
# From 2^WIDE_LOG2_BITS bits on, probes come from the 64-bit wide hash.
# Read when a filter is built or queried, so tests may lower it to drive
# that hash on a small filter.
WIDE_LOG2_BITS = 32
# bloom_set_bits ORs the filter one region of at most 2^14 words (64 KB,
# one CTA's shared memory) at a time.
REGION_WORDS_LOG2 = 14
# A row's probes must fit in one tile of the kernel's partition.
MAX_KERNEL_HASHES = 8192


class BloomFilter(NamedTuple):
    """bits: ``[2^log2_bits / 32] int32`` packed words; log2_bits and
    num_hashes are plain ints."""

    bits: torch.Tensor
    log2_bits: int
    num_hashes: int


def log2_ceil(n: int) -> int:
    return max(5, int(n - 1).bit_length())


def make_bloom(min_bits: int, num_hashes: int, device="cpu") -> BloomFilter:
    """Empty filter with at least ``min_bits`` bits (a power of two)."""
    lb = log2_ceil(min_bits)
    if lb > MAX_LOG2_BITS:
        raise ValueError(f"filter of 2^{lb} bits: at most "
                         f"2^{MAX_LOG2_BITS} bits (4 GiB of words) on one "
                         f"device")
    return BloomFilter(
        bits=torch.zeros(((1 << lb) // 32,), dtype=torch.int32,
                         device=device),
        log2_bits=lb, num_hashes=num_hashes)


def words_to_signed(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding uint32 values -> the int32 bit patterns."""
    words = words & MASK32
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _check_add_args(bf: BloomFilter, kmers: torch.Tensor, k: int,
                    mask: torch.Tensor | None):
    if kmers.dtype != torch.int64:
        raise TypeError(f"k-mer lanes must be int64, got {kmers.dtype}")
    lanes = (k + 15) // 16
    if kmers.shape[-1] != lanes:
        raise ValueError(f"k={k} needs {lanes} lanes, got {kmers.shape[-1]}")
    if bf.bits.dtype != torch.int32 or bf.bits.dim() != 1 \
            or bf.bits.shape[0] != (1 << bf.log2_bits) // 32:
        raise ValueError("filter words must be [2^log2_bits/32] int32")
    if bf.bits.device != kmers.device:
        raise ValueError(f"filter on {bf.bits.device}, k-mers on "
                         f"{kmers.device}")
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError(f"mask must be bool, got {mask.dtype}")
        if mask.device != kmers.device:
            raise ValueError("mask and k-mers on different devices")
        if mask.shape != kmers.shape[:-1]:
            raise ValueError(f"mask shape {tuple(mask.shape)} != "
                             f"{tuple(kmers.shape[:-1])}")


def probe_pair(bf: BloomFilter, kmers: torch.Tensor, k: int):
    """``(start, step)`` of each k-mer's probes in ``bf``: probe ``n`` is
    ``(start + n*step) mod 2^log2_bits``; the wide hash from
    ``2^WIDE_LOG2_BITS`` bits on, else the double hash."""
    if bf.log2_bits >= WIDE_LOG2_BITS:
        return hashing.wide_probe_pair(kmers, k, bf.log2_bits)
    return hashing.double_hash(kmers, k)


def _probe_bits(bf: BloomFilter, kmers: torch.Tensor,
                k: int) -> torch.Tensor:
    """Bit positions ``[num_hashes, ...]`` (int64) of each k-mer's
    probes."""
    return hashing.probe_positions(*probe_pair(bf, kmers, k), bf.num_hashes,
                                   bf.log2_bits)


def bloom_add_plain(bf: BloomFilter, kmers: torch.Tensor, k: int,
                    mask: torch.Tensor | None = None) -> BloomFilter:
    """Plain PyTorch insert: probe positions, sort, dedup, scatter-add.

    After the dedup each (word, bit) pair appears once, so the per-word
    sum of ``1 << bit`` equals the per-word OR."""
    _check_add_args(bf, kmers, k, mask)
    kmers = kmers.reshape(-1, kmers.shape[-1])
    if mask is not None:
        kmers = kmers[mask.reshape(-1)]
    pos = torch.sort(_probe_bits(bf, kmers, k).reshape(-1)).values
    keep = torch.ones_like(pos, dtype=torch.bool)
    keep[1:] = pos[1:] != pos[:-1]
    pos = pos[keep]
    delta = torch.zeros(bf.bits.shape, dtype=torch.int64,
                        device=bf.bits.device)
    delta.index_add_(0, pos >> 5, torch.ones_like(pos) << (pos & 31))
    return bf._replace(bits=bf.bits | words_to_signed(delta))


def region_layout(log2_bits: int) -> tuple[int, int]:
    """``(region_words, regions)`` of a ``2^log2_bits``-bit filter in
    ``bloom_set_bits``: regions of ``min(2^14, words)`` words."""
    words_log2 = log2_bits - 5
    region_log2 = min(REGION_WORDS_LOG2, words_log2)
    return 1 << region_log2, 1 << (words_log2 - region_log2)


def bloom_add_passes(bf: BloomFilter, kmers: torch.Tensor, k: int,
                     mask: torch.Tensor | None):
    """Launch ``bloom_set_bits``'s passes on the card, yielding after each;
    the generator returns the new filter (``kernels.run_passes``)."""
    lib = kernels.load_library()
    if bf.num_hashes > MAX_KERNEL_HASHES:
        raise ValueError(f"bloom_set_bits takes at most {MAX_KERNEL_HASHES} "
                         f"hashes, got {bf.num_hashes}")
    kmers = kmers.reshape(-1, kmers.shape[-1])
    if not kmers.is_contiguous() or not bf.bits.is_contiguous():
        raise ValueError("k-mer lanes and filter words must be contiguous")
    mask_ptr = None
    if mask is not None:
        mask = mask.reshape(-1)
        if not mask.is_contiguous():
            raise ValueError("mask must be contiguous")
        mask_ptr = mask.data_ptr()
    rows, lanes = kmers.shape
    dev = kmers.device
    region_words, regions = region_layout(bf.log2_bits)
    region_bits_log2 = region_words.bit_length() - 1 + 5
    top_log2, sub_log2 = kernels.partition_levels(regions.bit_length() - 1)
    ctas = kernels.partition_ctas(dev)
    probes = (kmers.data_ptr(), mask_ptr, rows, lanes,
              *(hashing.hash_init(k, seed) for seed in (
                  hashing.SEED_H1, hashing.SEED_H2, hashing.SEED_H3,
                  hashing.SEED_H4)),
              bf.num_hashes, bf.log2_bits,
              int(bf.log2_bits >= WIDE_LOG2_BITS), region_bits_log2,
              top_log2, sub_log2, ctas)
    hist = torch.zeros((ctas, 1 << top_log2), dtype=torch.int32, device=dev)
    kernels.launch(dev, lib.bloom_partition_count, *probes, hist.data_ptr())
    yield "partition count"
    offsets, top_start = kernels.partition_offsets(hist)
    part = torch.empty((rows * bf.num_hashes,), dtype=torch.int32,
                       device=dev)
    kernels.launch(dev, lib.bloom_partition_scatter, *probes,
                   offsets.data_ptr(), part.data_ptr())
    yield "partition scatter"
    regioned = torch.empty_like(part)
    start = torch.empty((regions + 1,), dtype=torch.int64, device=dev)
    kernels.launch(dev, lib.bloom_partition_refine, part.data_ptr(),
                   top_start.data_ptr(), region_bits_log2, top_log2,
                   sub_log2, regioned.data_ptr(), start.data_ptr())
    del part
    yield "partition refine"
    words = torch.empty_like(bf.bits)
    kernels.launch(dev, lib.bloom_region_or, regioned.data_ptr(),
                   start.data_ptr(), regions, region_words,
                   bf.bits.data_ptr(), words.data_ptr())
    yield "region OR"
    bloom_add.kernel_launches += 1
    return bf._replace(bits=words)


def bloom_add(bf: BloomFilter, kmers: torch.Tensor, k: int,
              mask: torch.Tensor | None = None) -> BloomFilter:
    """Insert a batch of canonical k-mers ``[..., L]`` (``BF::add``).

    ``mask`` (``[...] bool``) drops masked k-mers.  Returns a new filter;
    the input words are not modified.  A CUDA tensor goes through the
    ``bloom_set_bits`` kernel, a CPU tensor through ``bloom_add_plain``.
    """
    if kmers.device.type == "cpu":
        return bloom_add_plain(bf, kmers, k, mask)
    if not kmers.is_cuda:
        raise ValueError(f"unsupported device {kmers.device}")
    _check_add_args(bf, kmers, k, mask)
    return kernels.run_passes(bloom_add_passes(bf, kmers, k, mask))


bloom_add.kernel_launches = 0  # launches of bloom_set_bits


def bloom_query(bf: BloomFilter, kmers: torch.Tensor,
                k: int) -> torch.Tensor:
    """Batch membership query -> ``[...] bool``: AND over the
    ``num_hashes`` probe bits.  One probe at a time, so no
    ``[num_hashes, N]`` tensor is held."""
    start, step = probe_pair(bf, kmers, k)
    mask = (1 << bf.log2_bits) - 1
    hit = torch.ones(start.shape, dtype=torch.bool, device=start.device)
    for n in range(bf.num_hashes):
        pos = (start + n * step) & mask
        word = bf.bits[pos >> 5].to(torch.int64)
        hit &= ((word >> (pos & 31)) & 1) == 1
    return hit


def popcount(bf: BloomFilter) -> torch.Tensor:
    """The filter's set bits (0-dim int64 on its device), counted 2^24
    words at a time."""
    total = torch.zeros((), dtype=torch.int64, device=bf.bits.device)
    for words in bf.bits.split(1 << 24):
        x = words.to(torch.int64) & MASK32
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        total += ((x * 0x01010101) >> 24 & 0xFF).sum()
    return total


def bloom_merge(a: BloomFilter, b: BloomFilter) -> BloomFilter:
    """Bitwise-OR merge of two filters of one shape (sharded builds)."""
    assert a.log2_bits == b.log2_bits and a.num_hashes == b.num_hashes
    return a._replace(bits=a.bits | b.bits)
