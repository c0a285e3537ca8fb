"""Seed-component reachability on the contracted graph.

Port of ``platanus3_tpu/graph/reach.py`` without the staged flood.  The
reference materializes only what its seed-driven BFS visits (``MakeDBG``,
``src/DeBruijnGraph.cpp:93-155``); here a flood over the CONTRACTED graph
(junction nodes + unitigs as vertices) runs to its fixpoint.

Vertices: ``v in [0, M)`` junction-final nodes; ``M + uid`` unitigs.
"""

from __future__ import annotations

import torch

from platanus3_tpu_torch.graph.build import DBG
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import kmer as kmer_mod

__all__ = ["reachable"]


def _edge_targets(dbg: DBG) -> torch.Tensor:
    """[8M] FLAT contracted-vertex target of each junction edge (-1 none),
    column-major over the 8 (side, base) slots.  Neighbours absent from
    the node table (Bloom false positives) have no vertex."""
    m = dbg.nodes.shape[0]
    uid = dbg.node_state_uid
    cols = []
    for side_id, side_pres in ((dbg.left_id, dbg.left_present),
                               (dbg.right_id, dbg.right_present)):
        for b in range(4):
            nid = side_id[:, b]
            nidc = nid.clamp(0, m - 1)
            n_uid = torch.maximum(uid[2 * nidc], uid[2 * nidc + 1])
            tgt = torch.where(dbg.is_junction_final[nidc], nidc,
                              torch.where(n_uid >= 0, m + n_uid, -1))
            ok = side_pres[:, b] & (nid >= 0) & dbg.is_junction_final
            cols.append(torch.where(ok, tgt, -1))
    return torch.cat(cols)


def _flood_round(reach: torch.Tensor, e_tgt: torch.Tensor) -> torch.Tensor:
    """One propagation round over all edges (source ``i mod M``), forward
    then backward.  The fixpoint (the seed components) does not depend on
    how the edges are grouped into updates."""
    m = e_tgt.shape[0] // 8
    ok = e_tgt >= 0
    tgt = e_tgt[ok]
    src = torch.nonzero(ok).squeeze(1) % m
    new = reach.clone()
    new[tgt[new[src]]] = True
    new[src[new[tgt]]] = True
    return new


def _reach_setup(dbg: DBG, seed_fw, has_seed, *, k):
    """Seed-vertex resolution, initial reach mask and edge targets."""
    m = dbg.nodes.shape[0]
    nv = 3 * m
    canon, _ = kmer_mod.canonical(seed_fw, k)
    table = count_mod.KmerTable(dbg.nodes, torch.zeros_like(dbg.nodes[:, 0]),
                                dbg.size)
    sid = torch.where(has_seed, count_mod.lookup_id(table, canon), -1)
    sidc = sid.clamp(0, m - 1)
    s_uid = torch.maximum(dbg.node_state_uid[2 * sidc],
                          dbg.node_state_uid[2 * sidc + 1])
    s_vert = torch.where(dbg.is_junction_final[sidc], sidc,
                         torch.where(s_uid >= 0, m + s_uid, -1))
    s_vert = torch.where(sid >= 0, s_vert, -1)
    reach = torch.zeros((nv,), dtype=torch.bool, device=dbg.nodes.device)
    reach[s_vert[s_vert >= 0]] = True
    return reach, _edge_targets(dbg)


def reachable(dbg: DBG, seed_fw: torch.Tensor, has_seed: torch.Tensor,
              k: int):
    """-> (reach_junction [M] bool, reach_unitig [2M] bool).

    ``seed_fw [R, L]``: per-read seed k-mers in forward orientation; the
    flood starts from the vertices holding them."""
    m = dbg.nodes.shape[0]
    reach, e_tgt = _reach_setup(dbg, seed_fw, has_seed, k=k)
    while True:
        new = _flood_round(reach, e_tgt)
        changed = not torch.equal(new, reach)
        reach = new
        if not changed:
            break
    return reach[:m] & dbg.is_junction_final, reach[m:]
