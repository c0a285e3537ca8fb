"""Stage 3's coverage tally on the card: node coverage and junction
tallies of packed chunks, added into running tallies.

One launch of the hand-written kernel ``coverage_tally``
(``csrc/coverage_tally.cu``) adds what ``graph/coverage.count_coverage``
computes for a batch of chunks into the caller's ``node_cov [M]`` and
``jun_tally [M * 8]`` (int64), straight from the packed chunks.  It runs
where the chunks are on a CUDA device and ``k <= 32`` (one 64-bit value a
k-mer), ``uses_kernel``; ``graph/coverage.CoverageTally`` makes that
choice, and everywhere else runs ``count_coverage`` itself.

Where stage 1's per-position node ids are not given, the kernel finds each
position's node through a bucket directory over the sorted node keys,
``node_index``, built once a coverage pass: ``offsets[b]`` is the first
node row whose key's top ``bits`` bits (of its ``2k``) are at least ``b``,
about four rows a bucket.  A key's row is then a lower bound inside
``keys[offsets[b], offsets[b + 1])``, and the ids are
``count.lookup_id``'s: padding rows past ``size`` are in no bucket, and a
k = 32 key uses all 64 bits (the directory compares them unsigned).
``lookup_plain`` is the same search in plain PyTorch, which the CPU tests
hold to ``count.lookup_id``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from platanus3_tpu_torch import kernels
from platanus3_tpu_torch.constants import BASES_PER_LANE
from platanus3_tpu_torch.ops import count as count_mod

__all__ = ["MAX_KERNEL_K", "NodeIndex", "uses_kernel", "bucket_bits",
           "node_index", "lookup_plain", "coverage_tally"]

# The kernel's k-mers are one 64-bit value: at most two lanes.
MAX_KERNEL_K = 32
# The directory's offsets are int32.
_MAX_NODES = 2**31 - 1
_SIGN = -(1 << 63)


class NodeIndex(NamedTuple):
    """The bucket directory over a node table's sorted keys."""

    keys: torch.Tensor     # [M] int64: each row's 2k-bit key (a uint64's
                           # bits); rows past size are in no bucket
    offsets: torch.Tensor  # [2^bits + 1] int32: first row of each bucket,
                           # then size
    shift: int             # 2k - bits: a key's bucket is key >> shift


def uses_kernel(packed: torch.Tensor, k: int) -> bool:
    """True where ``coverage_tally`` runs: a CUDA tensor and ``k <= 32``."""
    return packed.is_cuda and k <= MAX_KERNEL_K


def bucket_bits(m: int, k: int) -> int:
    """Bits of the directory over ``m`` node rows: ``ceil(log2 m) - 2``,
    about four rows a bucket, at least 1 and at most ``2k``."""
    return max(1, min(2 * k, (max(m, 1) - 1).bit_length() - 2))


def _bucket(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """``keys >> shift`` with the keys read as unsigned 64-bit values."""
    if shift == 0:
        return keys
    return (keys >> shift) & ((1 << (64 - shift)) - 1)


def node_index(nodes: torch.Tensor, size, k: int) -> NodeIndex:
    """The bucket directory over the sorted node table ``nodes [M, L]``
    (``L <= 2``), whose first ``size`` rows are nodes (``size`` a 0-dim
    tensor or an int; nothing is read back to the host)."""
    m = nodes.shape[0]
    if nodes.shape[1] > 2 or m > _MAX_NODES:
        raise ValueError(f"node_index takes at most {_MAX_NODES} rows of at "
                         f"most two lanes, got {tuple(nodes.shape)}")
    bits = bucket_bits(m, k)
    shift = 2 * k - bits
    keys = count_mod.pack_keys(nodes)[:, 0].contiguous()
    row = torch.arange(m, device=nodes.device)
    bucket = torch.where(row < size, _bucket(keys, shift), 1 << bits)
    edges = torch.arange((1 << bits) + 1, device=nodes.device)
    offsets = torch.searchsorted(bucket, edges).to(torch.int32)
    return NodeIndex(keys=keys, offsets=offsets, shift=shift)


def lookup_plain(index: NodeIndex, canon: torch.Tensor) -> torch.Tensor:
    """Row of each ``[Q, L]`` canonical k-mer among the nodes, -1 where it
    is none: the kernel's directory search in plain PyTorch (a lower bound
    inside the key's bucket, compared as unsigned 64-bit values)."""
    m = index.keys.shape[0]
    q = count_mod.pack_keys(canon)[:, 0]
    b = _bucket(q, index.shift)
    lo = index.offsets[b].long()
    hi = index.offsets[b + 1].long()
    end = hi
    okeys, oq = index.keys ^ _SIGN, q ^ _SIGN
    for _ in range(max(1, m.bit_length())):
        mid = (lo + hi) >> 1
        right = (lo < hi) & (okeys[mid.clamp(max=m - 1)] < oq)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    hit = (lo < end) & (index.keys[lo.clamp(max=m - 1)] == q)
    return torch.where(hit, lo, -1)


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or t.device != dev or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def coverage_tally(node_cov, jun_tally, packed, vlen, start, rlen,
                   prev_base, next_base, *, k: int, is_jun, nid=None,
                   index: NodeIndex | None = None) -> None:
    """One launch of the ``coverage_tally`` kernel: add the coverage and
    junction tallies of the chunks ``packed [C, W]`` into ``node_cov [M]``
    and ``jun_tally [M * 8]`` in place.  ``nid [C, P]``: stage 1's node id
    of every position; where it is None, ``index`` (``node_index`` of the
    same node table) finds the nodes.  ``is_jun [M]`` bool:
    ``is_junction_final``."""
    dev = packed.device
    c, words = packed.shape
    m = node_cov.shape[0]
    np_ = words * BASES_PER_LANE - k + 1
    if not 0 < k <= MAX_KERNEL_K or np_ < 1:
        raise ValueError(f"coverage_tally takes k <= {MAX_KERNEL_K} and "
                         f"chunks of at least k bases, got k={k}, "
                         f"{words * BASES_PER_LANE} bases")
    i64 = torch.int64
    _check("packed", packed, i64, (c, words), dev)
    for name, t in (("valid_len", vlen), ("start", start), ("read_len", rlen),
                    ("prev_base", prev_base), ("next_base", next_base)):
        _check(name, t, i64, (c,), dev)
    _check("node_cov", node_cov, i64, (m,), dev)
    _check("jun_tally", jun_tally, i64, (m * 8,), dev)
    _check("is_jun", is_jun, torch.bool, (m,), dev)
    if nid is not None:
        _check("nid", nid, i64, (c, np_), dev)
    elif index is None:
        raise ValueError("coverage_tally needs stage 1's nid or a node_index")
    else:
        _check("index.keys", index.keys, i64, (m,), dev)
        bits = 2 * k - index.shift
        if not 0 < bits <= 2 * k:
            raise ValueError(f"index.shift {index.shift} does not fit k={k}")
        _check("index.offsets", index.offsets, torch.int32,
               ((1 << bits) + 1,), dev)
    lib = kernels.load_library()
    looked_up = nid is None
    kernels.launch(dev, lib.coverage_tally, packed.data_ptr(),
                   vlen.data_ptr(), start.data_ptr(), rlen.data_ptr(),
                   prev_base.data_ptr(), next_base.data_ptr(),
                   None if looked_up else nid.data_ptr(),
                   index.keys.data_ptr() if looked_up else None,
                   index.offsets.data_ptr() if looked_up else None,
                   index.shift if looked_up else 0, is_jun.data_ptr(),
                   node_cov.data_ptr(), jun_tally.data_ptr(), c, words, k)
    coverage_tally.kernel_launches += 1


coverage_tally.kernel_launches = 0  # launches of the coverage_tally kernel
