"""Exact k-mer counting via sort + run reduction.

Port of ``platanus3_tpu/ops/count.py``, at any k.  A k-mer's ``L`` lanes
pack into ``W = ceil(L / 2)`` 64-bit words: for odd ``L`` word 0 holds
lane 0 alone, and every other word holds two lanes, ``lane_a << 32 |
lane_b``, so one or two lanes are a single word.  Each word's sign bit is
flipped (the order key), so signed int64 order of the words, most
significant word first, is the unsigned lexicographic (``CompareBit``)
order:

* one word (k <= 32): the count is one ``torch.sort`` of the order keys;
* several words: LSB-first chained stable sorts, one per word, each
  applied through the permutation so far;
* invalid rows go last.  Where word 0 never uses its top bit (odd ``L``,
  or a top lane of fewer than 32 bits: the JAX package's
  ``_has_spare_msb``), invalid rows take the largest int64 there and sort
  last in the same passes; otherwise (k = 32, 64, 128, ...) one more
  stable sort on the invalid flag moves them last.

Node ids are the ranks of canonical k-mers in this order, exactly as in
the JAX package, so tables and per-position ids compare one to one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from platanus3_tpu_torch.ops.kmer import MASK32

__all__ = ["KmerTable", "pack_keys", "unpack_keys", "order_keys",
           "key_lanes", "run_starts", "run_totals",
           "sort_kmers", "sort_order_keys", "count_kmers",
           "count_positions_table", "count_solid_with_ids", "lookup_id",
           "lookup_id_join", "lookup_join", "merge_tables"]

_SIGN = -(1 << 63)          # int64 with only the sign bit set
_I64_MAX = (1 << 63) - 1


class KmerTable(NamedTuple):
    """Sorted unique canonical k-mers with counts.

    keys:   ``[cap, L] int64`` lexicographically sorted; rows >= size are
            all-ones (0xFFFFFFFF) padding
    counts: ``[cap] int64`` (0 beyond size)
    size:   0-dim int64 tensor -- number of valid rows
    """

    keys: torch.Tensor
    counts: torch.Tensor
    size: torch.Tensor


def pack_keys(kmers: torch.Tensor) -> torch.Tensor:
    """``[..., L]`` lanes -> ``[..., W]`` int64 words, ``W = ceil(L/2)``:
    for odd L word 0 is lane 0, and each other word two lanes, the first
    in its high half (a full word wraps to negative)."""
    lanes = kmers.shape[-1]
    odd = lanes % 2
    words = [kmers[..., 0]] if odd else []
    words += [(kmers[..., j] << 32) | kmers[..., j + 1]
              for j in range(odd, lanes, 2)]
    return torch.stack(words, dim=-1)


def unpack_keys(keys: torch.Tensor, lanes: int) -> torch.Tensor:
    """Inverse of :func:`pack_keys`: ``[..., W]`` words -> ``[..., L]``."""
    odd = lanes % 2
    cols = [keys[..., 0] & MASK32] if odd else []
    for w in range(odd, keys.shape[-1]):
        cols += [(keys[..., w] >> 32) & MASK32, keys[..., w] & MASK32]
    return torch.stack(cols, dim=-1)


def order_keys(kmers: torch.Tensor) -> torch.Tensor:
    """Packed words ``[..., W]`` whose signed int64 order, word 0 first,
    is the lexicographic order of the lanes."""
    return pack_keys(kmers) ^ _SIGN


def key_lanes(okey: torch.Tensor, lanes: int) -> torch.Tensor:
    """Inverse of :func:`order_keys`: order-key words -> ``[..., lanes]``."""
    return unpack_keys(okey ^ _SIGN, lanes)


def _spare_top(k: int | None, lanes: int) -> bool:
    """True when no valid order key's word 0 can equal the int64 maximum,
    so an invalid row can carry it: word 0 is one lane (odd L), or its top
    lane leaves bit 31 unused (2k not a multiple of 32)."""
    return k is not None and (lanes % 2 == 1 or (2 * k) % 32 != 0)


def _chained_perm(okey: torch.Tensor) -> torch.Tensor:
    """Permutation sorting ``[N, W]`` order keys, word 0 first: LSB-first
    stable sorts, each keeping the order of the less significant words
    among the rows its own word ties."""
    perm = None
    for w in reversed(range(okey.shape[1])):
        col = okey[:, w] if perm is None else okey[perm, w]
        _, p = torch.sort(col, stable=True)
        perm = p if perm is None else perm[p]
    return perm


def sort_order_keys(okey: torch.Tensor):
    """Sort ``[N, W]`` order keys (all valid) lexicographically.  Returns
    ``(sorted okey, perm)``; equal keys may come in any order."""
    if okey.shape[1] == 1:
        s_key, perm = torch.sort(okey[:, 0])
        return s_key[:, None], perm
    perm = _chained_perm(okey)
    return okey[perm], perm


def sort_kmers(kmers: torch.Tensor, invalid: torch.Tensor,
               k: int | None = None):
    """Order ``[N, L]`` keys lexicographically with invalid rows last.

    Returns ``(s_okey [N, W], s_invalid [N], perm [N])``: the sorted order
    keys, the sorted invalid flags and the permutation (sorted row i is
    input row ``perm[i]``).  Rows with equal keys may come in any order;
    the counting cores read only run aggregates and ``perm``.
    """
    okey = order_keys(kmers)
    words = okey.shape[1]
    spare = _spare_top(k, kmers.shape[1])
    if spare:
        okey[:, 0] = torch.where(invalid, _I64_MAX, okey[:, 0])
    if words == 1 and spare:
        s_key, perm = torch.sort(okey[:, 0])
        return s_key[:, None], invalid[perm], perm
    perm = _chained_perm(okey)
    if not spare:
        _, p = torch.sort(invalid[perm].to(torch.uint8), stable=True)
        perm = perm[p]
    return okey[perm], invalid[perm], perm


def run_starts(s_okey: torch.Tensor, s_invalid: torch.Tensor):
    """True at the first row of each run of equal (key, invalid) rows of
    a sorted table."""
    first = torch.ones_like(s_invalid)
    first[1:] = ((s_okey[1:] != s_okey[:-1]).any(dim=1)
                 | (s_invalid[1:] != s_invalid[:-1]))
    return first


def run_totals(is_first: torch.Tensor, contrib: torch.Tensor):
    """Per-row sum of ``contrib`` over the row's run."""
    seg = torch.cumsum(is_first.to(torch.int64), 0) - 1
    totals = torch.zeros(contrib.shape, dtype=torch.int64,
                         device=contrib.device)
    totals.index_add_(0, seg, contrib.to(torch.int64))
    return totals[seg]


def _compact_table(s_okey, tab_first, run_total, lanes: int,
                   want_counts: bool = True) -> KmerTable:
    """Table of the runs flagged by ``tab_first`` (in sorted order), padded
    to the input row count with all-ones keys and zero counts."""
    n = s_okey.shape[0]
    dev = s_okey.device
    first_keys = s_okey[tab_first]
    nt = first_keys.shape[0]
    keys = torch.full((n, lanes), MASK32, dtype=torch.int64, device=dev)
    keys[:nt] = key_lanes(first_keys, lanes)
    counts = torch.zeros((n,), dtype=torch.int64, device=dev)
    if want_counts:
        counts[:nt] = run_total[tab_first]
    size = torch.tensor(nt, dtype=torch.int64, device=dev)
    return KmerTable(keys=keys, counts=counts, size=size)


def _scan_count(kmers, valid, contributes, k, include_zero: bool,
                want_nid: bool, want_table: bool = True,
                want_counts: bool = True):
    """Sort + run reduction shared by the counting entry points.

    Returns ``(table | None, per_pos)``: ``per_pos`` is the run total per
    input row (0 for invalid rows), or with ``want_nid`` the table row of
    the row's k-mer (-1 when absent).  ``include_zero`` keeps valid runs
    without any contribution in the table.
    """
    l = kmers.shape[1]
    contributes = contributes & valid
    s_okey, s_invalid, perm = sort_kmers(kmers, ~valid, k=k)
    is_first = run_starts(s_okey, s_invalid)
    s_contrib = torch.where(s_invalid, 0, contributes[perm].to(torch.int64))
    run_total = run_totals(is_first, s_contrib)

    in_table = ~s_invalid if include_zero else (run_total > 0) & ~s_invalid
    tab_first = is_first & in_table
    if want_nid:
        # Within an in-table run only the first row is tab_first, so
        # every row of the run carries the run's table rank.
        tab_rank = torch.cumsum(tab_first.to(torch.int64), 0) - 1
        value_sorted = torch.where(in_table, tab_rank, -1)
    else:
        value_sorted = torch.where(s_invalid, 0, run_total)
    per_pos = torch.empty_like(value_sorted)
    per_pos[perm] = value_sorted

    if not want_table:
        return None, per_pos
    return _compact_table(s_okey, tab_first, run_total, l,
                          want_counts), per_pos


def count_kmers(kmers: torch.Tensor, valid: torch.Tensor,
                k: int | None = None) -> KmerTable:
    """Count the unique valid k-mers of a flat batch ``[N, L]``; the table
    capacity is N and ``size`` the unique count."""
    table, _ = _scan_count(kmers, valid, valid, k, include_zero=True,
                           want_nid=False)
    return table


def count_positions_table(kmers: torch.Tensor, valid: torch.Tensor,
                          contributes: torch.Tensor, k: int | None = None,
                          want_table: bool = True):
    """Per-position counts AND the contributing-unique table from ONE sort.

    Returns ``(KmerTable | None, per_position_counts [N])``: the table
    holds the k-mers with at least one contributing position; every valid
    position (contributing or not) gets its k-mer's count, invalid ones 0.
    """
    return _scan_count(kmers, valid, contributes, k, include_zero=False,
                       want_nid=False, want_table=want_table)


def count_solid_with_ids(kmers: torch.Tensor, valid: torch.Tensor,
                         contributes: torch.Tensor, k: int | None = None,
                         want_counts: bool = True):
    """Solid-node table AND per-position node ids from ONE sort.

    Returns ``(KmerTable, per_pos_nid [N])``: the table holds the unique
    k-mers with at least one contribution, and ``per_pos_nid[i]`` is the
    table row of position i's k-mer (-1 when absent or invalid)."""
    return _scan_count(kmers, valid, contributes, k, include_zero=False,
                       want_nid=True, want_counts=want_counts)


def _table_order_keys(table: KmerTable) -> torch.Tensor:
    """One-word order keys of the table rows, padding rows set to the
    int64 maximum so the whole column stays sorted."""
    m = table.keys.shape[0]
    row = torch.arange(m, device=table.keys.device)
    return torch.where(row < table.size, order_keys(table.keys)[:, 0],
                       _I64_MAX)


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a < b`` over ``[..., W]`` order keys, word 0 first."""
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(less)
    for w in range(a.shape[-1]):
        less |= eq & (a[..., w] < b[..., w])
        eq &= a[..., w] == b[..., w]
    return less


def _lower_bound(tkey: torch.Tensor, size, qkey: torch.Tensor):
    """First row of the sorted ``tkey [M, W]`` prefix ``[0, size)`` not
    below each query of ``qkey [Q, W]``: a binary search of all queries at
    once, ``bit_length(M)`` rounds of one gather each."""
    m = tkey.shape[0]
    lo = torch.zeros(qkey.shape[:1], dtype=torch.int64, device=qkey.device)
    hi = torch.as_tensor(size, dtype=torch.int64,
                         device=qkey.device).expand_as(lo).clone()
    for _ in range(max(1, m.bit_length())):
        mid = (lo + hi) >> 1
        right = (lo < hi) & _lex_less(tkey[mid.clamp(max=m - 1)], qkey)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    return lo


def lookup_id(table: KmerTable, queries: torch.Tensor) -> torch.Tensor:
    """Row index of each ``[Q, L]`` query in the table, or -1 when absent.

    One word (k <= 32): ``searchsorted`` over the packed keys.  Several
    words: a lexicographic binary search over the ``[M, W]`` order keys
    (``_lower_bound``), bounded by ``size``.  A search rather than the JAX
    package's sort-join: it reads the table ``log2(M)`` times at random
    but sorts nothing, where a join sorts the table and the queries
    together word by word (``W + 1`` passes over ``M + Q`` rows); and it
    keeps the queries in their order, so no scatter back."""
    qkey = order_keys(queries)
    m = table.keys.shape[0]
    if qkey.shape[-1] == 1:
        tkey = _table_order_keys(table)
        pos = torch.searchsorted(tkey, qkey[:, 0])
        pos_c = pos.clamp(max=m - 1)
        hit = (tkey[pos_c] == qkey[:, 0]) & (pos < table.size)
        return torch.where(hit, pos_c, -1)
    tkey = order_keys(table.keys)
    pos = _lower_bound(tkey, table.size, qkey)
    pos_c = pos.clamp(max=m - 1)
    hit = (tkey[pos_c] == qkey).all(dim=1) & (pos < table.size)
    return torch.where(hit, pos_c, -1)


def lookup_id_join(table: KmerTable, queries: torch.Tensor,
                   k: int | None = None) -> torch.Tensor:
    """Same ids as :func:`lookup_id`.  The JAX package joins by one sort
    of table and queries (binary-search gathers are slow on a TPU); on a
    GPU a binary search over the packed keys is the direct form."""
    return lookup_id(table, queries)


def lookup_join(table: KmerTable, queries: torch.Tensor) -> torch.Tensor:
    """Count of each ``[Q, L]`` query in the table, 0 when absent (the JAX
    package's ``count.lookup_join``), through :func:`lookup_id`."""
    nid = lookup_id(table, queries)
    return torch.where(nid >= 0, table.counts[nid.clamp(min=0)], 0)


def merge_tables(a: KmerTable, b: KmerTable) -> KmerTable:
    """Merge two count tables: the union of their valid keys, sorted, with
    summed counts.  Capacity is ``cap_a + cap_b``."""
    ka = a.keys.shape[0]
    keys = torch.cat([a.keys, b.keys], dim=0)
    counts = torch.cat([a.counts, b.counts], dim=0)
    row = torch.arange(keys.shape[0], device=keys.device)
    invalid = ~((row < a.size) | ((row >= ka) & (row < ka + b.size)))
    s_okey, s_invalid, perm = sort_kmers(keys, invalid)
    is_first = run_starts(s_okey, s_invalid)
    run_total = run_totals(is_first, torch.where(s_invalid, 0, counts[perm]))
    return _compact_table(s_okey, is_first & ~s_invalid, run_total,
                          keys.shape[1])
