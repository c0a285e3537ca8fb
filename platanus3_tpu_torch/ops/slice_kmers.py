"""Slice k-mers: what each slice pass of streaming passes 1-2 reads of a
slice's packed chunks.

The four slice passes of ``ops/partitioned.py`` (the two histogram
pre-passes and the two collects) each start again from a slice's packed
chunks.  Per chunk-local position they need the canonical k-mer of the
pass (``short_k`` in pass 1, ``k`` in pass 2), whether it is valid and
owned, in pass 2 its window-min solidity from the per-position short
counts, and its hash partition.  Per mode this module returns:

* histogram: the slice's rows per partition, ``[parts]`` int64 (valid
  short k-mers in pass 1, solid owned k-mers in pass 2);
* collect-short: ``(okey [n, W], pay [n] int32, part [n] int64)``, the
  order keys (``count.order_keys``), the payloads ``posid | owned << 31``
  and the partition ids (``parts`` = dropped), ``n = chunks * P``;
* collect-solid: ``(okey [n, W], part [n], chunk_min [C], chunk_fw [C,
  L])``: the rows, and each chunk's first solid position ``start + p``
  (``NO_SEED`` where there is none) and that k-mer's forward lanes (0
  where there is none), the seed reduction's input.

On a CUDA device with ``k <= 32`` (one order-key word, at most two lanes)
one launch of the hand-written kernel ``slice_kmers``
(``csrc/slice_kmers.cu``) computes a mode's outputs; every other case --
the CPU, and ``k > 32`` on any device -- runs the plain PyTorch chain,
``short_slice_plain`` / ``solid_slice_plain``: ``unpack_bases`` ->
``extract_kmers`` -> ``canonical`` -> ``owned_mask`` -> ``window_min`` ->
``part_of`` -> ``order_keys``.  Both give the same arrays.  The partition
hash and seed are the JAX package's ``_part_of``, so histograms and plans
compare array-equal with it.
"""

from __future__ import annotations

import torch

from platanus3_tpu_torch import kernels
from platanus3_tpu_torch.constants import BASES_PER_LANE
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import hashing as hash_mod
from platanus3_tpu_torch.ops import kmer as kmer_mod
from platanus3_tpu_torch.ops import solid as solid_mod
from platanus3_tpu_torch.ops.windowmin import window_min

__all__ = ["PART_SEED", "NO_SEED", "MAX_KERNEL_K", "part_of", "part_counts",
           "uses_kernel", "short_slice", "short_slice_plain", "solid_slice",
           "solid_slice_plain", "slice_kmers"]

PART_SEED = 0x51C3A27D
NO_SEED = 2 ** 30          # chunk_min of a chunk without a solid position
_MSB = 1 << 31
# The kernel's k-mers are one 64-bit value: two lanes, one order-key word.
MAX_KERNEL_K = 32
# Per-warp partition counters of a histogram CTA live in shared memory.
_MAX_KERNEL_PARTS = 1024

_SHORT_HISTOGRAM, _SOLID_HISTOGRAM, _SHORT_COLLECT, _SOLID_COLLECT = range(4)


def part_of(canon, kk: int, valid, parts: int):
    """Hash partition id per row (int64; ``parts`` = dropped)."""
    h = hash_mod.hash_kmers(canon, kk, seed=PART_SEED)
    return torch.where(valid, h & (parts - 1), parts)


def part_counts(part, parts: int):
    """Rows per partition of ``part`` (``[parts]`` int64; the dropped id
    ``parts`` is not counted)."""
    return torch.bincount(part, minlength=parts + 1)[:parts]


def uses_kernel(packed: torch.Tensor, k: int) -> bool:
    """True where ``slice_kmers`` runs: a CUDA tensor and ``k <= 32``
    (``short_k <= k``)."""
    return packed.is_cuda and k <= MAX_KERNEL_K


# ---------------------------------------------------------------------------
# The plain chain

def _short_kmers(packed, vlen, start, rlen, k: int, short_k: int):
    """Canonical short k-mers of a slice and their valid / owned masks."""
    bases = kmer_mod.unpack_bases(packed)
    stride = bases.shape[1] - k + 1
    return solid_mod.short_kmer_positions(bases, vlen, start, rlen, stride,
                                          short_k, k)


def _solid_kmers(counts, packed, vlen, start, rlen, posbase_s, *, k,
                 short_k, cov_threshold):
    """Window-min solidity of a slice from the per-position counts (one
    contiguous ``narrow`` of ``counts``).  Returns ``(fw, canon,
    solid_owned)`` of the k-mers, ``[C, Pk, L]`` and ``[C, Pk]``."""
    bases = kmer_mod.unpack_bases(packed)
    c, chunk_len = bases.shape
    stride = chunk_len - k + 1
    p_short = chunk_len - short_k + 1
    per_pos = counts.narrow(0, posbase_s, c * p_short).reshape(c, p_short)
    cov_est = window_min(per_pos, k - short_k + 1)
    fw, valid_k = kmer_mod.extract_kmers(bases, vlen, k)
    canon, _ = kmer_mod.canonical(fw, k)
    owned_k = solid_mod.owned_mask(start, rlen, stride, fw.shape[1], k,
                                   k) & valid_k
    return fw, canon, (cov_est >= cov_threshold) & valid_k & owned_k


def short_slice_plain(packed, vlen, start, rlen, posbase, *, k, short_k,
                      parts, collect):
    """Plain PyTorch version of :func:`short_slice`."""
    s_canon, s_valid, s_owned = _short_kmers(packed, vlen, start, rlen, k,
                                             short_k)
    n = s_canon.shape[0] * s_canon.shape[1]
    part = part_of(s_canon, short_k, s_valid, parts).reshape(n)
    if not collect:
        return part_counts(part, parts)
    okey = count_mod.order_keys(s_canon.reshape(n, -1))
    pos = posbase + torch.arange(n, dtype=torch.int64, device=okey.device)
    pay = torch.where(s_owned.reshape(n), pos - _MSB, pos).to(torch.int32)
    return okey, pay, part


def solid_slice_plain(counts, packed, vlen, start, rlen, posbase_s, *, k,
                      short_k, cov_threshold, parts, collect):
    """Plain PyTorch version of :func:`solid_slice`."""
    fw, canon, solid_owned = _solid_kmers(
        counts, packed, vlen, start, rlen, posbase_s, k=k, short_k=short_k,
        cov_threshold=cov_threshold)
    c, pk, lk = canon.shape
    part = part_of(canon, k, solid_owned, parts).reshape(-1)
    if not collect:
        return part_counts(part, parts)
    okey = count_mod.order_keys(canon.reshape(c * pk, lk))
    gpos = start[:, None] + torch.arange(pk, dtype=torch.int64,
                                         device=canon.device)[None, :]
    chunk_min, arg = torch.where(solid_owned, gpos, NO_SEED).min(dim=1)
    chunk_fw = torch.where((chunk_min < NO_SEED)[:, None],
                           fw[torch.arange(c, device=fw.device), arg], 0)
    return okey, part, chunk_min, chunk_fw


# ---------------------------------------------------------------------------
# The kernel

def _check_slice(packed, vlen, start, rlen, counts):
    dev = packed.device
    for name, t in (("packed", packed), ("valid_len", vlen),
                    ("start", start), ("read_len", rlen)):
        if t.dtype != torch.int64 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int64 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if t.shape[0] != packed.shape[0]:
            raise ValueError(f"{name} has {t.shape[0]} chunks, packed "
                             f"{packed.shape[0]}")
    if counts is not None and (counts.dtype != torch.int32
                               or counts.device != dev
                               or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous int32 tensor on the "
                         "slice's device")


def slice_kmers(mode: int, packed, vlen, start, rlen, counts, posbase: int,
                *, k, short_k, cov_threshold, parts):
    """One launch of the ``slice_kmers`` kernel in ``mode`` (histogram,
    collect-short or collect-solid; pass 2 reads ``counts``).  Returns the
    mode's outputs as :func:`short_slice` and :func:`solid_slice` do."""
    _check_slice(packed, vlen, start, rlen, counts)
    if not short_k <= k <= MAX_KERNEL_K:
        raise ValueError(f"slice_kmers takes short_k <= k <= {MAX_KERNEL_K}, "
                         f"got short_k={short_k}, k={k}")
    if parts & (parts - 1) or not 0 < parts <= _MAX_KERNEL_PARTS:
        raise ValueError(f"parts must be a power of two up to "
                         f"{_MAX_KERNEL_PARTS}, got {parts}")
    c, words = packed.shape
    solid = mode in (_SOLID_HISTOGRAM, _SOLID_COLLECT)
    kk = k if solid else short_k
    np_ = words * BASES_PER_LANE - kk + 1
    if np_ < 1:
        raise ValueError(f"chunk width {words * BASES_PER_LANE} too small "
                         f"for k={kk}")
    if solid and posbase + c * (words * BASES_PER_LANE - short_k + 1) \
            > counts.shape[0]:
        raise ValueError("the slice's positions run past the counts")
    dev = packed.device
    i64 = dict(dtype=torch.int64, device=dev)
    hist = okey = part = pay = chunk_min = chunk_fw = None
    if mode in (_SHORT_HISTOGRAM, _SOLID_HISTOGRAM):
        hist = torch.zeros((parts,), **i64)
    else:
        okey = torch.empty((c * np_, 1), **i64)
        part = torch.empty((c * np_,), **i64)
        if mode == _SHORT_COLLECT:
            pay = torch.empty((c * np_,), dtype=torch.int32, device=dev)
        else:
            chunk_min = torch.empty((c,), **i64)
            chunk_fw = torch.empty((c, kmer_mod.num_lanes(k)), **i64)
    lib = kernels.load_library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    kernels.launch(dev, lib.slice_kmers, mode, packed.data_ptr(),
                   vlen.data_ptr(), start.data_ptr(), rlen.data_ptr(),
                   ptr(counts), c, words, k, short_k, parts, cov_threshold,
                   posbase, hash_mod.hash_init(kk, PART_SEED), ptr(hist),
                   ptr(okey), ptr(part), ptr(pay), ptr(chunk_min),
                   ptr(chunk_fw))
    slice_kmers.kernel_launches += 1
    if hist is not None:
        return hist
    if pay is not None:
        return okey, pay, part
    return okey, part, chunk_min, chunk_fw


slice_kmers.kernel_launches = 0  # launches of the slice_kmers kernel


# ---------------------------------------------------------------------------
# The passes' entry points

def short_slice(packed, vlen, start, rlen, posbase: int = 0, *, k, short_k,
                parts, collect):
    """Pass 1 over one slice: its histogram, or with ``collect`` its rows
    ``(okey, pay, part)``.  ``posbase``: global position id of the slice's
    first chunk-local position (collect only)."""
    if uses_kernel(packed, k):
        return slice_kmers(_SHORT_COLLECT if collect else _SHORT_HISTOGRAM,
                           packed, vlen, start, rlen, None, posbase, k=k,
                           short_k=short_k, cov_threshold=0, parts=parts)
    return short_slice_plain(packed, vlen, start, rlen, posbase, k=k,
                             short_k=short_k, parts=parts, collect=collect)


def solid_slice(counts, packed, vlen, start, rlen, posbase_s: int, *, k,
                short_k, cov_threshold, parts, collect):
    """Pass 2 over one slice, solidity from ``counts`` (per position, from
    ``posbase_s`` on): its histogram of the solid owned rows, or with
    ``collect`` its rows and seed candidates ``(okey, part, chunk_min,
    chunk_fw)``."""
    if uses_kernel(packed, k):
        return slice_kmers(_SOLID_COLLECT if collect else _SOLID_HISTOGRAM,
                           packed, vlen, start, rlen, counts, posbase_s, k=k,
                           short_k=short_k, cov_threshold=cov_threshold,
                           parts=parts)
    return solid_slice_plain(counts, packed, vlen, start, rlen, posbase_s,
                             k=k, short_k=short_k,
                             cov_threshold=cov_threshold, parts=parts,
                             collect=collect)
