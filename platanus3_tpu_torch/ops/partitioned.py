"""Hash-partitioned k-mer accumulation for streaming.

Port of ``platanus3_tpu/ops/partitioned.py``.  The streaming passes are
*collect -> count*, so that every position is sorted once, and no slice
sorts a whole table:

  pass 1 (collect): each slice extracts its canonical short k-mers and
      appends them -- (order key, position id | owned flag) rows -- to
      ``NUM_PARTS`` hash-partitioned buffers;
  pass 1 (count): each partition is sorted once, and every row's run
      total is scattered to a per-POSITION counts array through its
      position id;
  pass 2 (collect): window-min solidity reads the per-position counts as
      one contiguous ``narrow`` (no lookup), appends the solid owned
      canonical k-mers to a second buffer set, reduces the per-read seeds
      and, in Bloom membership, adds them to the filter (``bloom_add``:
      one ``bloom_set_bits`` launch a slice on the card);
  pass 2 (count): each partition is sorted once and deduplicated; the
      partitions' unique sets are disjoint, so one sort of their
      concatenation gives the lex-sorted node table of the single-shot
      pipeline.

Each slice pass reads its slice through ``ops/slice_kmers.py``: one
launch of the ``slice_kmers`` kernel a slice pass on the card (k <= 32),
the plain PyTorch chain elsewhere.  Capacities come from a histogram
pre-pass per pass (``plan_caps``, as in the JAX package, whose
``_part_of`` hash and seed are kept so that histograms and plans compare
array-equal).  What differs from the JAX package:

* a buffer set is a tuple of tensors: the rows' ``[rows, W]`` int64 order
  keys (``count.order_keys``: W = ceil(L/2) words), and in pass 1 an
  int32 payload holding the JAX ``uint32`` bit pattern ``posid | owned <<
  31``;
* rows are appended densely: one stable sort of the slice's partition
  ids, then one scatter to ``bases[p] + fills[p] + rank``, so no block
  of padding is copied (the JAX package writes fixed-size blocks by
  ``dynamic_update_slice`` and lets the next block overwrite the tail);
* the count and dedup passes sort only a partition's ``fills[p]`` rows
  (``narrow``), not its whole capacity with invalid rows last.  Rows of
  equal keys may come in any order in both packages: only run
  aggregates are observable.
"""

from __future__ import annotations

import numpy as np
import torch

from platanus3_tpu_torch.ops import bloom as bloom_mod
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import kmer as kmer_mod
from platanus3_tpu_torch.ops import slice_kmers as sk
from platanus3_tpu_torch.utils.profiling import timed_part

__all__ = ["NUM_PARTS", "plan_caps", "histogram_short_slice",
           "histogram_solid_slice", "collect_short_slice",
           "count_partition", "solid_collect_slice", "dedup_partition",
           "place_block", "finalize_table", "make_buffers", "NO_SEED"]

# Number of hash partitions, as the JAX package (histograms and plans
# compare one to one).
NUM_PARTS = 16

NO_SEED = sk.NO_SEED       # min_pos of a read without a seed


def plan_caps(hist_total, hist_slice_max, parts: int):
    """Buffer plan from the measured per-partition loads (verbatim from
    the JAX package).

    Every occurrence of a k-mer lands in its hash's partition, so repeat
    families load some partitions far above the mean; the histogram
    pre-pass measures the exact per-partition totals and per-(slice,
    partition) maxima, and extraction is deterministic, so capacities
    planned from it cannot overflow.

    Returns ``(s_blks tuple, caps tuple, bases tuple, total_rows)``:
    per-partition per-slice block sizes (rounded up to 2^16) and
    capacities (rounded up to 2^21, or 2^23 above 2^23), plus flat-buffer
    base offsets.
    """
    hist_total = np.asarray(hist_total)
    hist_slice_max = np.asarray(hist_slice_max)
    s_blks, caps = [], []
    for p in range(parts):
        sb = int(-(-int(hist_slice_max[p] + 1) // (1 << 16)) * (1 << 16))
        cap = int(hist_total[p]) + sb  # + one block of junk tail
        step = (1 << 23) if cap > (1 << 23) else (1 << 21)
        cap = -(-cap // step) * step
        s_blks.append(sb)
        caps.append(cap)
    bases = [0]
    for c in caps[:-1]:
        bases.append(bases[-1] + c)
    return (tuple(s_blks), tuple(caps), tuple(bases),
            bases[-1] + caps[-1])


def make_buffers(total_rows: int, words: int, payload: bool, device):
    """An empty buffer set: ``[total_rows, words]`` order keys and, with
    ``payload``, ``[total_rows]`` int32 payloads.  Unwritten rows are
    never read (each partition is read up to its fill)."""
    keys = torch.empty((total_rows, words), dtype=torch.int64, device=device)
    if not payload:
        return (keys,)
    return keys, torch.empty((total_rows,), dtype=torch.int32, device=device)


def _append_partitioned(cols, part, bufs, fills, ovf, *, parts, s_blks,
                        caps, bases):
    """Append the rows of ``cols`` (one tensor a buffer, rows first) to
    their partitions.  ``part [N]``: target partition per row, ``parts``
    drops the row.  Partition p holds rows ``[bases[p], bases[p] +
    fills[p])``.  The overflow latch is the JAX package's invariant check
    (a slice above its block, or a partition above its capacity less one
    block); planned capacities cannot trip it."""
    dev = part.device
    cnt = sk.part_counts(part, parts)
    s_blk = torch.tensor(s_blks, dtype=torch.int64, device=dev)
    cap = torch.tensor(caps, dtype=torch.int64, device=dev)
    ovf = ovf | ((cnt > s_blk) | (fills + cnt > cap - s_blk)).any()
    s_part, perm = torch.sort(part, stable=True)
    keep = s_part < parts
    s_part, perm = s_part[keep], perm[keep]
    first = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(s_part.shape[0], device=dev) - first[s_part]
    base = torch.tensor(bases, dtype=torch.int64, device=dev)
    dest = base[s_part] + fills[s_part] + rank
    for buf, col in zip(bufs, cols):
        buf[dest] = col[perm]
    return bufs, fills + cnt, ovf


def histogram_short_slice(hist_total, hist_max, packed, vlen, start, rlen,
                          *, k, short_k, parts):
    """Pre-pass: per-partition valid-row counts of one slice; updates the
    running totals and per-slice maxima (``[parts]`` int64 each)."""
    h = sk.short_slice(packed, vlen, start, rlen, k=k, short_k=short_k,
                       parts=parts, collect=False)
    return hist_total + h, torch.maximum(hist_max, h)


def histogram_solid_slice(hist_total, hist_max, counts, packed, vlen, start,
                          rlen, posbase_s, *, k, short_k, cov_threshold,
                          parts):
    """Pre-pass for the node buffers: per-partition SOLID OWNED row counts
    of one slice (the collect's solidity)."""
    h = sk.solid_slice(counts, packed, vlen, start, rlen, posbase_s, k=k,
                       short_k=short_k, cov_threshold=cov_threshold,
                       parts=parts, collect=False)
    return hist_total + h, torch.maximum(hist_max, h)


def collect_short_slice(bufs, fills, ovf, packed, vlen, start, rlen, posbase,
                        *, k, short_k, parts, s_blks, caps, bases):
    """Pass-1 collect: append this slice's valid canonical short k-mers as
    (order key, posid | owned << 31) rows.  ``posbase``: global position
    id of the slice's first chunk-local position."""
    okey, pay, part = sk.short_slice(packed, vlen, start, rlen, posbase,
                                     k=k, short_k=short_k, parts=parts,
                                     collect=True)
    return _append_partitioned((okey, pay), part, bufs, fills, ovf,
                               parts=parts, s_blks=s_blks, caps=caps,
                               bases=bases)


def _sorted_partition(keys, fills, pidx: int, pbase: int):
    """The partition's rows sorted by key: ``(sorted okey, perm,
    is_first)``."""
    rows = keys.narrow(0, pbase, int(fills[pidx]))
    s_okey, perm = count_mod.sort_order_keys(rows)
    first = torch.ones((s_okey.shape[0],), dtype=torch.bool,
                       device=keys.device)
    first[1:] = (s_okey[1:] != s_okey[:-1]).any(dim=1)
    return s_okey, perm, first


def count_partition(counts, bufs, fills, pidx: int, pbase: int):
    """Pass-1 count: sort the partition's ``fills[pidx]`` rows once and
    scatter every row's run total (the count of OWNED copies of its
    k-mer) to ``counts[posid]``.  Returns ``(counts, n_unique)``."""
    keys, pay = bufs
    _, perm, first = _sorted_partition(keys, fills, pidx, pbase)
    s_pay = pay.narrow(0, pbase, perm.shape[0])[perm]
    run_total = count_mod.run_totals(first, (s_pay < 0).to(torch.int64))
    posid = (s_pay & 0x7FFFFFFF).to(torch.int64)
    counts[posid] = run_total.to(counts.dtype)
    return counts, int(first.sum())


def solid_collect_slice(bufs, fills, ovf, min_pos, seed_fw, bf, counts,
                        packed, vlen, rid, start, rlen, posbase_s, *, k,
                        short_k, cov_threshold, num_reads, parts, s_blks,
                        caps, bases, add_bloom, timer=None):
    """Pass-2 collect: window-min solidity from the counts, the Bloom
    insert (``add_bloom``; one ``bloom_set_bits`` launch on the card,
    timed as part ``pass2.bloom_insert`` of ``timer``'s span), the
    per-read first-solid seed reduction, and the append of the solid
    owned canonical k-mers to the node buffers.  Returns ``(bufs, fills,
    ovf, min_pos, seed_fw, bf)``.

    Seeds: the first solid owned position of each read (``start +
    local``), in forward form.  A read's chunks may straddle slices, so
    the per-read minimum is carried in ``min_pos`` (2^30 = none) and a
    slice's winner replaces the seed only where it comes earlier.  Owned
    positions of one read are distinct, so each read has at most one
    winning chunk."""
    okey, part, chunk_min, chunk_fw = sk.solid_slice(
        counts, packed, vlen, start, rlen, posbase_s, k=k, short_k=short_k,
        cov_threshold=cov_threshold, parts=parts, collect=True)
    lk = chunk_fw.shape[1]
    dev = okey.device
    if add_bloom:
        with timed_part(timer, "pass2.bloom_insert"):
            bf = bloom_mod.bloom_add(bf, count_mod.key_lanes(okey, lk), k,
                                     mask=part < parts)

    batch_min = torch.full((num_reads,), NO_SEED, dtype=torch.int64,
                           device=dev)
    batch_min.scatter_reduce_(0, rid, chunk_min, reduce="amin")
    win = (chunk_min < NO_SEED) & (chunk_min == batch_min[rid])
    # Losing chunks write to a spare row, so no mask is read on the host.
    batch_seed = torch.zeros((num_reads + 1, lk), dtype=torch.int64,
                             device=dev)
    batch_seed[torch.where(win, rid, num_reads)] = chunk_fw
    seed_fw = torch.where((batch_min < min_pos)[:, None],
                          batch_seed[:num_reads], seed_fw)
    min_pos = torch.minimum(min_pos, batch_min)

    bufs, fills, ovf = _append_partitioned(
        (okey,), part, bufs, fills, ovf, parts=parts, s_blks=s_blks,
        caps=caps, bases=bases)
    return bufs, fills, ovf, min_pos, seed_fw, bf


def dedup_partition(bufs, fills, pidx: int, pbase: int, *, k):
    """Pass-2 count: sort one node partition once and keep each distinct
    k-mer once.  Returns ``(unique lanes [n, L], n)``."""
    s_okey, _, first = _sorted_partition(bufs[0], fills, pidx, pbase)
    uniq = s_okey[first]
    return (count_mod.key_lanes(uniq, kmer_mod.num_lanes(k)),
            uniq.shape[0])


def place_block(dst, out, offset: int):
    """Write one partition's unique block into the concatenation buffer
    at ``offset``."""
    dst[offset:offset + out.shape[0]] = out
    return dst


def finalize_table(dst, n_total: int, *, k):
    """One sort of the (disjoint) per-partition uniques: the lex-sorted
    node table of the single-shot pipeline."""
    valid = torch.arange(dst.shape[0], device=dst.device) < n_total
    return count_mod.count_kmers(dst, valid, k=k)
