"""Blocked packed Bloom filter: every probe of a k-mer in one 64 KB block.

Port of the blocked filter of ``platanus3_tpu/ops/bloom_pallas.py``
(``build_blocked_bloom``, ``query_blocked``), for 2^19 to 2^35 bits.  The
filter is ``2^log2_bits / 32`` packed words in block-major order, held in
an ``int32`` tensor (the ``uint32`` bit patterns).  The top
``log2_bits - 19`` bits of ``h1`` pick one 2^19-bit (16384-word) block,
and probe ``n`` sets bit ``p & 31`` of the block's word ``p >> 5``, where
``p = (h1 + n*h2) & (2^19 - 1)``.  The bit placement is the JAX
package's, so the words are bit-equal to its Pallas build; the filter
must be queried with ``query_blocked``.

``build_blocked_bloom`` is the wrapper of the hand-written CUDA kernel
``bloom_blocked_set_bits`` (``csrc/bloom.cu``), which replaces the Pallas
kernel ``bloom_pallas._blocked_kernel``.  On a CUDA tensor it launches
the kernel; on a CPU tensor it runs the plain PyTorch version,
``build_blocked_bloom_plain`` (block and position per probe, sort, dedup,
``index_add_``, as ``bloom.bloom_add_plain`` does for the flat filter).
The kernel partitions one item a masked-in k-mer (the low 19 bits of
``h1`` and ``h2``) by block in two levels (``blocked_layout``; count,
scatter and refine passes with scratch of two ``rows`` int64 arrays),
then builds each block from zero in one CTA's shared memory and writes
every word, so the output is allocated and never filled.

Unlike the JAX package, the build drops no row.  The Pallas kernel gives
each block ``c_max = ceil(1.6 * N / blocks / 2048) + 2`` chunks of 2048
rows and reports the rows past them as overflow, so its words can miss
inserted k-mers; here a block takes any number of rows, the words are
those of every masked-in row, and the overflow is always 0.  Where the
Pallas overflow is 0 the words are equal.
"""

from __future__ import annotations

import torch

from platanus3_tpu_torch import kernels
from platanus3_tpu_torch.ops import hashing
from platanus3_tpu_torch.ops.bloom import words_to_signed

__all__ = ["build_blocked_bloom", "build_blocked_bloom_plain",
           "build_blocked_bloom_passes", "blocked_layout", "query_blocked",
           "BLOCK_WORDS", "MIN_LOG2_BITS", "MAX_LOG2_BITS"]

BLOCK_WORDS = 1 << 14
_BLOCK_BITS_LOG2 = 19
_BB_MASK = (1 << _BLOCK_BITS_LOG2) - 1
MIN_LOG2_BITS = 19   # one block
# The JAX package's int32 word index ``blk * 2^14`` holds up to here.
MAX_LOG2_BITS = 35


def _check_log2_bits(log2_bits: int):
    if not MIN_LOG2_BITS <= log2_bits <= MAX_LOG2_BITS:
        raise ValueError(f"blocked filter of 2^{log2_bits} bits: needs "
                         f"{MIN_LOG2_BITS} <= log2_bits <= {MAX_LOG2_BITS}")


def blocked_layout(log2_bits: int) -> tuple[int, int, int]:
    """``(top_log2, sub_log2, blocks)`` of a ``2^log2_bits``-bit filter in
    ``bloom_blocked_set_bits``: its ``2^(log2_bits - 19)`` blocks split
    into the partition's top buckets and sub-buckets."""
    _check_log2_bits(log2_bits)
    g = log2_bits - _BLOCK_BITS_LOG2
    return (*kernels.partition_levels(g), 1 << g)


def _blocked_hashes(kmers: torch.Tensor, k: int, log2_bits: int):
    """``(nblk, blk, h1, h2)``: block count, each k-mer's block, and its
    double hash."""
    _check_log2_bits(log2_bits)
    g = log2_bits - _BLOCK_BITS_LOG2
    h1, h2 = hashing.double_hash(kmers, k)
    blk = h1 >> (32 - g) if g else torch.zeros_like(h1)
    return 1 << g, blk, h1, h2


def _check_build_args(kmers: torch.Tensor, k: int, mask, log2_bits: int):
    _check_log2_bits(log2_bits)
    if kmers.dtype != torch.int64 or kmers.dim() != 2:
        raise TypeError(f"k-mers must be [N, L] int64, got "
                        f"{tuple(kmers.shape)} {kmers.dtype}")
    lanes = (k + 15) // 16
    if kmers.shape[1] != lanes:
        raise ValueError(f"k={k} needs {lanes} lanes, got {kmers.shape[1]}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != kmers.shape[:1]:
            raise ValueError(f"mask must be [{kmers.shape[0]}] bool")
        if mask.device != kmers.device:
            raise ValueError("mask and k-mers on different devices")


def _result(words: torch.Tensor, return_overflow: bool):
    if return_overflow:
        # No chunk budget, so no row is dropped (module docstring).
        return words, torch.zeros((), dtype=torch.int64, device=words.device)
    return words


def build_blocked_bloom_plain(kmers: torch.Tensor, k: int,
                              mask: torch.Tensor | None, log2_bits: int,
                              num_hashes: int,
                              return_overflow: bool = False):
    """Plain PyTorch build: global bit index of every probe, sort, dedup,
    then a scatter-add of the bit values (after the dedup the per-word sum
    equals the per-word OR)."""
    _check_build_args(kmers, k, mask, log2_bits)
    if mask is not None:
        kmers = kmers[mask]
    _, blk, h1, h2 = _blocked_hashes(kmers, k, log2_bits)
    pos = (hashing.probe_positions(h1, h2, num_hashes, _BLOCK_BITS_LOG2)
           + (blk << _BLOCK_BITS_LOG2)[None])
    pos = torch.sort(pos.reshape(-1)).values
    keep = torch.ones_like(pos, dtype=torch.bool)
    keep[1:] = pos[1:] != pos[:-1]
    pos = pos[keep]
    delta = torch.zeros(((1 << log2_bits) // 32,), dtype=torch.int64,
                        device=kmers.device)
    delta.index_add_(0, pos >> 5, torch.ones_like(pos) << (pos & 31))
    return _result(words_to_signed(delta), return_overflow)


def build_blocked_bloom_passes(kmers: torch.Tensor, k: int, mask,
                               log2_bits: int, num_hashes: int):
    """Launch ``bloom_blocked_set_bits``'s passes on the card, yielding
    after each; the generator returns the words (``kernels.run_passes``)."""
    lib = kernels.load_library()
    if not kmers.is_contiguous() or (mask is not None
                                     and not mask.is_contiguous()):
        raise ValueError("k-mer lanes and mask must be contiguous")
    rows, lanes = kmers.shape
    dev = kmers.device
    top_log2, sub_log2, blocks = blocked_layout(log2_bits)
    ctas = kernels.partition_ctas(dev)
    args = (kmers.data_ptr(), None if mask is None else mask.data_ptr(),
            rows, lanes, hashing.hash_init(k, hashing.SEED_H1),
            hashing.hash_init(k, hashing.SEED_H2), top_log2, sub_log2, ctas)
    hist = torch.zeros((ctas, 1 << top_log2), dtype=torch.int32, device=dev)
    kernels.launch(dev, lib.bloom_blocked_partition_count, *args,
                   hist.data_ptr())
    yield "partition count"
    offsets, top_start = kernels.partition_offsets(hist)
    part = torch.empty((rows,), dtype=torch.int64, device=dev)
    kernels.launch(dev, lib.bloom_blocked_partition_scatter, *args,
                   offsets.data_ptr(), part.data_ptr())
    yield "partition scatter"
    blocked = torch.empty_like(part)
    start = torch.empty((blocks + 1,), dtype=torch.int64, device=dev)
    kernels.launch(dev, lib.bloom_blocked_partition_refine, part.data_ptr(),
                   top_start.data_ptr(), top_log2, sub_log2,
                   blocked.data_ptr(), start.data_ptr())
    del part
    yield "partition refine"
    words = torch.empty((blocks * BLOCK_WORDS,), dtype=torch.int32,
                        device=dev)
    kernels.launch(dev, lib.bloom_block_build, blocked.data_ptr(),
                   start.data_ptr(), blocks, num_hashes, words.data_ptr())
    yield "block build"
    build_blocked_bloom.kernel_launches += 1
    return words


def build_blocked_bloom(kmers: torch.Tensor, k: int,
                        mask: torch.Tensor | None, log2_bits: int,
                        num_hashes: int, return_overflow: bool = False):
    """Build a blocked filter from canonical ``[N, L]`` k-mers.

    ``mask [N] bool`` drops masked rows (``None`` keeps all).  Returns
    ``[2^log2_bits / 32] int32`` words and, with ``return_overflow``, a
    0-dim overflow count that is always 0 (no row is dropped, unlike the
    JAX package's build: module docstring).  A CUDA tensor goes through the
    ``bloom_blocked_set_bits`` kernel, a CPU tensor through
    ``build_blocked_bloom_plain``.
    """
    if kmers.device.type == "cpu":
        return build_blocked_bloom_plain(kmers, k, mask, log2_bits,
                                         num_hashes, return_overflow)
    if not kmers.is_cuda:
        raise ValueError(f"unsupported device {kmers.device}")
    _check_build_args(kmers, k, mask, log2_bits)
    return _result(kernels.run_passes(build_blocked_bloom_passes(
        kmers, k, mask, log2_bits, num_hashes)), return_overflow)


build_blocked_bloom.kernel_launches = 0  # launches of bloom_blocked_set_bits


def query_blocked(words: torch.Tensor, kmers: torch.Tensor, k: int,
                  log2_bits: int, num_hashes: int) -> torch.Tensor:
    """Membership query against a blocked filter -> ``[...] bool``: AND
    over the ``num_hashes`` probe bits, one probe at a time."""
    _, blk, h1, h2 = _blocked_hashes(kmers, k, log2_bits)
    base = blk * BLOCK_WORDS
    hit = torch.ones(h1.shape, dtype=torch.bool, device=h1.device)
    for n in range(num_hashes):
        p = (h1 + n * h2) & _BB_MASK
        word = words[base + (p >> 5)].to(torch.int64)
        hit &= ((word >> (p & 31)) & 1) == 1
    return hit
