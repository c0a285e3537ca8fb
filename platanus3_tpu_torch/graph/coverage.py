"""Node coverage + junction edge tallies as scatter-adds.

Port of ``platanus3_tpu/graph/coverage.py`` (reference
``DeBruijnGraph::CountNodeCoverage``, ``src/DeBruijnGraph.cpp:393-449``):

* node coverage: +1 per owned read position whose k-mer is a node, +2
  for a palindromic k-mer (the reference adds both orientations);
* junction tallies: at a position matching a junction in forward
  orientation, the preceding read base increments the LEFT tally and the
  following base the RIGHT tally; a reverse match mirrors both through
  the complement.  Tallies are relative to the canonical orientation.

``count_coverage`` is the plain PyTorch chain over one batch of unpacked
chunks.  ``CoverageTally`` sums a coverage pass over batches of packed
chunks (a single shot's one batch, or streaming's slices): on a CUDA
device at ``k <= 32`` each batch is one launch of the hand-written kernel
``coverage_tally`` (``ops/coverage_tally.py``), which adds into the
running tallies; the CPU and ``k > 32`` run ``count_coverage``.  Both give
the same tallies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from platanus3_tpu_torch.graph.build import DBG
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import coverage_tally as tally_mod
from platanus3_tpu_torch.ops import kmer as kmer_mod

__all__ = ["CoverageResult", "CoverageTally", "count_coverage"]


class CoverageResult(NamedTuple):
    node_cov: torch.Tensor     # [M] coverage per node id
    jun_tally: torch.Tensor    # [M*8] FLAT (row nid*8 + col); cols 0-3 left
                               # A/C/G/T, 4-7 right A/C/G/T


def count_coverage(dbg: DBG, k: int, bases, valid_len, start, read_len,
                   prev_base, next_base, nid=None) -> CoverageResult:
    """One pass over the chunked read batch.

    ``bases [C, chunk_len]`` unpacked codes.  ``nid [C, Pk]``: per-position
    node ids from stage 1 (``count_solid_with_ids``); when ``None`` (after
    the Bloom closure renumbered the nodes) they are looked up here.
    """
    m, l = dbg.nodes.shape
    c, chunk_len = bases.shape
    stride = chunk_len - k + 1
    dev = bases.device

    fw, valid = kmer_mod.extract_kmers(bases, valid_len, k)
    canon, is_fw = kmer_mod.canonical(fw, k)
    del fw
    pk = canon.shape[1]
    local = torch.arange(pk, dtype=torch.int64, device=dev)[None, :]
    in_read = start[:, None] + local + k <= read_len[:, None]
    owned = (local < stride) & in_read & valid

    if nid is None:
        table = count_mod.KmerTable(dbg.nodes,
                                    torch.zeros_like(dbg.nodes[:, 0]),
                                    dbg.size)
        nid = count_mod.lookup_id_join(table, canon.reshape(-1, l)).reshape(
            c, pk)
    hit = owned & (nid >= 0)
    pal = kmer_mod.is_palindrome(canon, k)
    del canon
    nid_c = nid.clamp(0, m - 1)

    # ---- node coverage ---------------------------------------------------
    inc = torch.where(hit, torch.where(pal, 2, 1), 0)
    node_cov = torch.zeros((m,), dtype=torch.int64, device=dev)
    node_cov.index_add_(0, nid_c.reshape(-1), inc.reshape(-1))

    # ---- junction edge tallies ------------------------------------------
    is_jun = dbg.is_junction_final[nid_c] & hit
    prev_in = torch.cat([prev_base[:, None], bases[:, :pk - 1]], dim=1)
    has_prev = torch.where(local == 0, prev_base[:, None] < 4, True)
    nxt_in = torch.cat([bases[:, k:], next_base[:, None]], dim=1)
    g_next_ok = start[:, None] + local + k <= read_len[:, None] - 1
    has_next = g_next_ok & torch.where(local == pk - 1,
                                       next_base[:, None] < 4, True)

    tally = torch.zeros((m * 8,), dtype=torch.int64, device=dev)

    def scatter_tally(col, active):
        idx = (nid * 8 + col)[active]
        tally.index_add_(0, idx, torch.ones_like(idx))

    # forward hit: left[prev], right[next]; reverse: right[3-prev],
    # left[3-next]
    scatter_tally(torch.where(is_fw, prev_in, 7 - prev_in), is_jun & has_prev)
    scatter_tally(torch.where(is_fw, 4 + nxt_in, 3 - nxt_in),
                  is_jun & has_next)
    return CoverageResult(node_cov=node_cov, jun_tally=tally)


class CoverageTally:
    """Node coverage and junction tallies of one coverage pass, summed
    over the batches of chunks given to ``add``; ``result()`` returns
    them.  On the kernel's path the first add allocates the tallies, and
    the first add without stage 1's ids builds the node table's bucket
    directory (``coverage_tally.node_index``), which ``result()`` lets
    go."""

    def __init__(self, dbg: DBG, k: int):
        self.dbg, self.k = dbg, k
        self.node_cov = self.jun_tally = None
        self._index = None

    def add(self, packed, valid_len, start, read_len, prev_base, next_base,
            nid=None) -> None:
        """Add the tallies of the chunks ``packed [C, W]`` (``nid [C, P]``
        stage 1's per-position node ids, or None to look them up)."""
        dbg, k = self.dbg, self.k
        if not tally_mod.uses_kernel(packed, k):
            cov = count_coverage(dbg, k, kmer_mod.unpack_bases(packed),
                                 valid_len, start, read_len, prev_base,
                                 next_base, nid=nid)
            if self.node_cov is None:
                self.node_cov, self.jun_tally = cov
            else:
                self.node_cov += cov.node_cov
                self.jun_tally += cov.jun_tally
            return
        self._allocate()
        if nid is None and self._index is None:
            self._index = tally_mod.node_index(dbg.nodes, dbg.size, k)
        tally_mod.coverage_tally(
            self.node_cov, self.jun_tally, packed, valid_len, start,
            read_len, prev_base, next_base, k=k,
            is_jun=dbg.is_junction_final.contiguous(), nid=nid,
            index=self._index)

    def result(self) -> CoverageResult:
        self._allocate()
        self._index = None
        return CoverageResult(node_cov=self.node_cov,
                              jun_tally=self.jun_tally)

    def _allocate(self) -> None:
        if self.node_cov is None:
            m = self.dbg.nodes.shape[0]
            i64 = dict(dtype=torch.int64, device=self.dbg.nodes.device)
            self.node_cov = torch.zeros((m,), **i64)
            self.jun_tally = torch.zeros((m * 8,), **i64)
