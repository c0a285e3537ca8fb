"""Solid-k-mer selection: short-k counting -> window-min -> solidity mask,
and the per-read seed k-mers.

Port of ``platanus3_tpu/ops/solid.py`` (stages A+B of the reference,
``src/Load.cpp:105-127`` and ``src/MakeBloomFilter.cpp:24-89``).  The
Bloom filter is not built here: the pipeline builds it from the distinct
node table (``pipeline._bloom_from_nodes``), as the JAX main path does.

Chunk geometry (io/reads.py): a chunk owns local positions ``[0,
stride)``; the window of an owned large position touches only short
positions inside the same chunk (``chunk_len >= 2k``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import kmer as kmer_mod
from platanus3_tpu_torch.ops.windowmin import window_min

__all__ = ["SolidResult", "short_kmer_positions", "solid_kmers",
           "owned_mask", "first_solid_per_read"]


class SolidResult(NamedTuple):
    """Per-chunk outputs of the solidity stage.

    canon, fw: ``[C, Pk, L]`` canonical / forward large k-mer per position
    is_solid:  ``[C, Pk] bool`` window-min >= threshold and in-read
    owned:     ``[C, Pk] bool`` position owned by this chunk
    short_table: KmerTable of exact short-k counts (None unless asked)
    cov_est:   ``[C, Pk]`` window-min coverage estimate per position
    """

    canon: torch.Tensor
    fw: torch.Tensor
    is_solid: torch.Tensor
    owned: torch.Tensor
    short_table: Optional[count_mod.KmerTable]
    cov_est: torch.Tensor


def owned_mask(start, read_len, stride, p, kk, k):
    """[C, p] bool: chunk-local position owned by this chunk.

    For ``kk < k`` the read's LAST chunk also owns the tail positions
    ``[stride, stride + k - kk)``, which no later chunk exists to own."""
    local = torch.arange(p, dtype=torch.int64, device=start.device)[None, :]
    in_read = start[:, None] + local + kk <= read_len[:, None]
    owned = local < stride
    if kk < k:
        is_last = (start + stride)[:, None] > (read_len - k)[:, None]
        owned = owned | is_last
    return owned & in_read


def short_kmer_positions(bases, valid_len, start, read_len, stride,
                         short_k: int, k: int):
    """Canonical short k-mers + (valid, owned) masks per chunk position."""
    fw, valid = kmer_mod.extract_kmers(bases, valid_len, short_k)
    canon, _ = kmer_mod.canonical(fw, short_k)
    owned = owned_mask(start, read_len, stride, canon.shape[1], short_k,
                       k) & valid
    return canon, valid, owned


def solid_kmers(batch_arrays, k: int, short_k: int, cov_threshold: int,
                need_short_table: bool = True) -> SolidResult:
    """Solidity stage over a chunked read batch.

    ``batch_arrays`` = (packed, valid_len, read_id, start, read_len) as
    tensors on one device; ``stride = chunk_len - k + 1``.
    """
    packed, valid_len, read_id, start, read_len = batch_arrays
    bases = kmer_mod.unpack_bases(packed)
    c, chunk_len = bases.shape
    stride = chunk_len - k + 1

    # Stage A: exact short-k counting; one sort yields the per-position
    # counts the window-min consumes (and the table when asked for).
    s_canon, s_valid, s_owned = short_kmer_positions(
        bases, valid_len, start, read_len, stride, short_k, k)
    l_s = s_canon.shape[-1]
    short_table, per_pos = count_mod.count_positions_table(
        s_canon.reshape(-1, l_s), s_valid.reshape(-1), s_owned.reshape(-1),
        k=short_k, want_table=need_short_table)
    del s_canon, s_valid, s_owned
    short_counts = per_pos.reshape(c, -1)

    # Stage B: window-min solidity.
    w = k - short_k + 1
    assert w >= 1, f"k ({k}) must be >= short_k ({short_k})"
    cov_est = window_min(short_counts, w)

    fw, valid_k = kmer_mod.extract_kmers(bases, valid_len, k)
    canon, _ = kmer_mod.canonical(fw, k)
    pk = fw.shape[1]
    owned_k = owned_mask(start, read_len, stride, pk, k, k) & valid_k
    assert cov_est.shape[1] == pk, (cov_est.shape, pk)
    is_solid = (cov_est >= cov_threshold) & valid_k
    return SolidResult(canon=canon, fw=fw, is_solid=is_solid, owned=owned_k,
                       short_table=short_table, cov_est=cov_est)


def first_solid_per_read(result: SolidResult, read_id, start,
                         num_reads: int):
    """Seed k-mers: the first solid owned large k-mer of each read, in
    FORWARD form (``src/MakeBloomFilter.cpp:79-83``).

    Returns ``(seed_fw [R, L], has_seed [R] bool)``.  Chunks are
    read-major with ascending start, so the flat (chunk, position) index
    order is global position order within each read.
    """
    c, pk, l = result.fw.shape
    n = c * pk
    dev = result.fw.device
    big = 2 ** 30
    flat = (torch.arange(c, dtype=torch.int64, device=dev)[:, None] * pk
            + torch.arange(pk, dtype=torch.int64, device=dev)[None, :])
    cand = torch.where(result.is_solid & result.owned, flat, big)
    chunk_min = cand.min(dim=1).values
    min_flat = torch.full((num_reads,), big, dtype=torch.int64, device=dev)
    min_flat.scatter_reduce_(0, read_id, chunk_min, reduce="amin")
    has_seed = min_flat < big
    idx = min_flat.clamp(0, n - 1)
    seed = torch.where(has_seed[:, None], result.fw.reshape(n, l)[idx], 0)
    return seed, has_seed
