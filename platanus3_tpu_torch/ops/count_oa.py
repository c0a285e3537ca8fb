"""Exact k-mer count table by open addressing.

Port of ``platanus3_tpu/ops/count_pallas.py``, at any k.  The table has ``T = 2^g * 8192`` slots in ``2^g`` blocks of
8192, with ``g`` from the row count exactly as in the JAX package.  A
k-mer with hash ``h1`` (``hashing.hash_kmers`` with ``SEED_H1``) lives in
block ``h1 >> (32 - g)`` (block 0 when ``g = 0``), at the first slot
reached by linear probing from ``h1 & 8191`` that holds it or was empty,
wrapping inside its block.  A slot is occupied iff its count is > 0.

``count_kmers_oa`` is the wrapper of the hand-written CUDA kernel
``oa_count_insert`` (``csrc/count_oa.cu``), which replaces the Pallas
kernel ``count_pallas._insert_kernel``.  On a CUDA tensor it launches the
kernel; on a CPU tensor it runs the plain PyTorch version,
``count_kmers_oa_plain``.  The kernel partitions the rows' packed keys
(for rows of more than two lanes, their indices) by block in two levels (count, scatter and refine passes, with scratch of
two ``rows`` int64 arrays; ``kernels.partition_levels``), then builds
each block in one CTA's shared memory, which writes every slot of the
keys and counts once, so the wrapper allocates them unfilled.  Slot
layout depends on the order of inserts (the kernel's atomics, the JAX
kernel's hash sort), so tables compare through ``oa_to_sorted``.

Empty marker.  An empty slot holds 0xFFFFFFFF in every lane; for one or
two lanes the kernel claims a slot by a compare-and-swap on the packed
key ``lane0 << 32 | lane1`` against the value with all 64 bits set.  That
key is never a canonical k-mer: where the top lane is full it is T^k,
whose reverse complement A^k = 0 is smaller, and otherwise it lies
outside the 2k-bit range.  A contributing row equal to it is counted in
``overflow`` by both versions, never dropped silently.

Overflow.  On the card only a row whose block's 8192 slots are all taken
by other keys is overflow (and a row with the empty marker's value).  The
JAX ``overflow`` also counts rows past its chunk budget, a TPU artefact
this kernel does not have.  Both are 0 in every healthy run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from platanus3_tpu_torch import kernels
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import hashing
from platanus3_tpu_torch.ops.kmer import MASK32

__all__ = ["OAHashTable", "count_kmers_oa", "count_kmers_oa_plain",
           "oa_passes", "oa_to_sorted", "table_log2_blocks",
           "probe_violations"]

TB_LOG2 = 13
TB = 1 << TB_LOG2
# Target load factor per block (the JAX sizing rule's 4096 rows a block).
LOAD = 0.5


class OAHashTable(NamedTuple):
    """Open-addressing exact k-mer count table (hash-partitioned).

    keys:     ``[L, T] int64`` lane-major, each a uint32 value; empty
              slots hold 0xFFFFFFFF in every lane
    counts:   ``[T] int32``; slot occupied iff > 0
    overflow: 0-dim int64 -- contributing rows left out (0 in any healthy
              run)
    """

    keys: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def table_log2_blocks(rows: int) -> int:
    """``g`` of the JAX sizing rule, quirk included: below 4096 rows
    ``(-1).bit_length()`` is 1, so 500 rows get 2 blocks and 5000 get 1."""
    return max(0, (int(rows / (TB * LOAD)) - 1).bit_length())


def _check_args(kmers: torch.Tensor, contrib: torch.Tensor, k: int):
    if kmers.dtype != torch.int64 or kmers.dim() != 2:
        raise TypeError(f"k-mers must be [N, L] int64, got "
                        f"{tuple(kmers.shape)} {kmers.dtype}")
    lanes = (k + 15) // 16
    if kmers.shape[1] != lanes:
        raise ValueError(f"k={k} needs {lanes} lanes, got {kmers.shape[1]}")
    if contrib.dtype != torch.bool or contrib.shape != kmers.shape[:1]:
        raise ValueError(f"contrib must be [{kmers.shape[0]}] bool")
    if contrib.device != kmers.device:
        raise ValueError("contrib and k-mers on different devices")


def _block_and_home(h1: torch.Tensor, g: int):
    """Global index of each key's block start, and its home slot."""
    blk = h1 >> (32 - g) if g else torch.zeros_like(h1)
    return blk << TB_LOG2, h1 & (TB - 1)


def count_kmers_oa_plain(kmers: torch.Tensor, contrib: torch.Tensor,
                         k: int) -> OAHashTable:
    """Plain PyTorch build of a valid table with the kernel's addressing.

    Equal keys are aggregated first; the unique keys are then placed in
    probing rounds: each unplaced key tries its next slot, and among keys
    that try the same empty slot the one with the smallest index wins
    (``scatter_reduce`` ``amin``).  Losers and keys that met another key
    move one slot on; a key that has tried all 8192 slots of its block is
    overflow, with all its rows.
    """
    _check_args(kmers, contrib, k)
    n, lanes = kmers.shape
    dev = kmers.device
    g = table_log2_blocks(n)
    t = TB << g
    rows_in = kmers[contrib]
    empty = (rows_in == MASK32).all(dim=1)
    overflow = empty.sum()
    packed = count_mod.pack_keys(rows_in[~empty])
    del rows_in
    if packed.shape[1] == 1:
        uniq, rows = torch.unique(packed[:, 0], return_counts=True)
        uniq = uniq[:, None]
    else:
        uniq, rows = torch.unique(packed, dim=0, return_counts=True)
    uniq = count_mod.unpack_keys(uniq, lanes)

    h1 = hashing.hash_kmers(uniq, k, hashing.SEED_H1)
    base, home = _block_and_home(h1, g)
    owner = torch.full((t,), -1, dtype=torch.int64, device=dev)
    counts = torch.zeros((t,), dtype=torch.int32, device=dev)
    todo = torch.arange(uniq.shape[0], device=dev)
    step = torch.zeros_like(todo)
    nobody = uniq.shape[0]
    winner = torch.full((t,), nobody, dtype=torch.int64, device=dev)
    while todo.numel():
        slot = base[todo] + ((home[todo] + step) & (TB - 1))
        free = owner[slot] < 0
        winner.scatter_reduce_(0, slot[free], todo[free], reduce="amin")
        won = free & (winner[slot] == todo)
        winner[slot[free]] = nobody
        owner[slot[won]] = todo[won]
        counts[slot[won]] = rows[todo[won]].to(torch.int32)
        step = step + 1
        keep = ~won & (step < TB)
        overflow = overflow + rows[todo[~won & (step == TB)]].sum()
        todo, step = todo[keep], step[keep]

    keys = torch.full((t, lanes), MASK32, dtype=torch.int64, device=dev)
    occupied = owner >= 0
    keys[occupied] = uniq[owner[occupied]]
    return OAHashTable(keys=keys.T.contiguous(), counts=counts,
                       overflow=overflow.to(torch.int64))


def oa_passes(kmers: torch.Tensor, contrib: torch.Tensor, k: int):
    """Launch ``oa_count_insert``'s passes on the card, yielding after
    each; the generator returns the table (``kernels.run_passes``)."""
    lib = kernels.load_library()
    if not kmers.is_contiguous() or not contrib.is_contiguous():
        raise ValueError("k-mer lanes and contrib must be contiguous")
    n, lanes = kmers.shape
    dev = kmers.device
    g = table_log2_blocks(n)
    top_log2, sub_log2 = kernels.partition_levels(g)
    ctas = kernels.partition_ctas(dev)
    init1 = hashing.hash_init(k, hashing.SEED_H1)
    rows = (kmers.data_ptr(), contrib.data_ptr(), n, lanes, init1, top_log2,
            sub_log2, ctas)
    hist = torch.zeros((ctas, 1 << top_log2), dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    kernels.launch(dev, lib.oa_partition_count, *rows, hist.data_ptr(),
                   overflow.data_ptr())
    yield "partition count"
    offsets, top_start = kernels.partition_offsets(hist)
    part = torch.empty((n,), dtype=torch.int64, device=dev)
    kernels.launch(dev, lib.oa_partition_scatter, *rows, offsets.data_ptr(),
                   part.data_ptr())
    yield "partition scatter"
    blocked = torch.empty_like(part)
    start = torch.empty(((1 << g) + 1,), dtype=torch.int64, device=dev)
    kernels.launch(dev, lib.oa_partition_refine, part.data_ptr(),
                   top_start.data_ptr(), kmers.data_ptr(), lanes, init1,
                   top_log2, sub_log2, blocked.data_ptr(), start.data_ptr())
    del part
    yield "partition refine"
    keys = torch.empty((lanes, TB << g), dtype=torch.int64, device=dev)
    counts = torch.empty((TB << g,), dtype=torch.int32, device=dev)
    kernels.launch(dev, lib.oa_block_insert, blocked.data_ptr(),
                   start.data_ptr(), kmers.data_ptr(), lanes, init1, g,
                   keys.data_ptr(), counts.data_ptr(), overflow.data_ptr())
    yield "block insert"
    count_kmers_oa.kernel_launches += 1
    return OAHashTable(keys=keys, counts=counts, overflow=overflow)


def count_kmers_oa(kmers: torch.Tensor, contrib: torch.Tensor,
                   k: int) -> OAHashTable:
    """Exact counts of canonical ``[N, L]`` k-mers (open addressing).

    ``contrib [N] bool``: rows that add +1 (invalid or padding rows
    False).  A CUDA tensor goes through the ``oa_count_insert`` kernel, a
    CPU tensor through ``count_kmers_oa_plain``.
    """
    if kmers.device.type == "cpu":
        return count_kmers_oa_plain(kmers, contrib, k)
    if not kmers.is_cuda:
        raise ValueError(f"unsupported device {kmers.device}")
    _check_args(kmers, contrib, k)
    return kernels.run_passes(oa_passes(kmers, contrib, k))


count_kmers_oa.kernel_launches = 0  # launches of oa_count_insert


def oa_to_sorted(table: OAHashTable) -> count_mod.KmerTable:
    """The lexicographically sorted ``KmerTable`` of the occupied slots,
    with capacity ``T`` (for equality tests against the sort counter)."""
    lanes, t = table.keys.shape
    dev = table.keys.device
    occ = table.counts > 0
    keys = table.keys.T[occ]
    s_okey, _, perm = count_mod.sort_kmers(
        keys, torch.zeros(keys.shape[:1], dtype=torch.bool, device=dev))
    size = keys.shape[0]
    out_keys = torch.full((t, lanes), MASK32, dtype=torch.int64, device=dev)
    out_keys[:size] = count_mod.key_lanes(s_okey, lanes)
    out_counts = torch.zeros((t,), dtype=torch.int64, device=dev)
    out_counts[:size] = table.counts[occ][perm].to(torch.int64)
    return count_mod.KmerTable(
        keys=out_keys, counts=out_counts,
        size=torch.tensor(size, dtype=torch.int64, device=dev))


def probe_violations(table: OAHashTable, k: int) -> int:
    """Occupied slots that linear probing could not reach: those with an
    empty slot of their block between their home slot and themselves.
    0 for every table either version builds."""
    lanes, t = table.keys.shape
    dev = table.keys.device
    g = (t >> TB_LOG2).bit_length() - 1
    occ = (table.counts > 0).reshape(-1, TB)
    idx = torch.arange(TB, device=dev).expand_as(occ)
    # Last empty slot at or before each slot, inside its block; before the
    # block's first empty slot, the wrap-around takes its last one.
    last_empty = torch.where(occ, -1, idx).cummax(dim=1).values
    wrap = torch.where(occ, -1, idx).max(dim=1, keepdim=True).values - TB
    # A block with no empty slot gets a run longer than the block.
    last_empty = torch.where(last_empty < 0, wrap, last_empty).reshape(-1)

    at = occ.reshape(-1).nonzero().squeeze(1)
    h1 = hashing.hash_kmers(table.keys.T[at], k, hashing.SEED_H1)
    base, home = _block_and_home(h1, g)
    dist = (at - base - home) & (TB - 1)
    pos = at & (TB - 1)
    bad = dist >= pos - last_empty[at]
    return int(bad.sum())
