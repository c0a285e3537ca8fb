"""Device-side emission packing: sequences + compact junction tables.

Port of ``platanus3_tpu/graph/emit.py``.  Output work stays on the
device and only what the GFA contains is copied to the host:

* ``materialize_sequences`` scatters every unitig's characters into one
  flat code array with per-unitig offsets (about genome size in bytes);
* ``pack_junctions`` gathers the reached-junction rows and everything
  their S/L lines need into ``[jun_cap, ...]`` tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from platanus3_tpu_torch.graph.build import DBG
from platanus3_tpu_torch.ops import kmer as kmer_mod

__all__ = ["SeqPack", "JunPack", "materialize_sequences", "pack_junctions"]


class SeqPack(NamedTuple):
    flat: torch.Tensor      # [char_cap] uint8 base codes (0..3)
    offs: torch.Tensor      # [ucap + 1] exclusive offsets
    ulen: torch.Tensor      # [ucap] chain length (nodes)
    circular: torch.Tensor  # [ucap] bool


class JunPack(NamedTuple):
    node_id: torch.Tensor       # [jun_cap] node row (m = invalid)
    kmers: torch.Tensor         # [jun_cap, L]
    cov: torch.Tensor           # [jun_cap]
    tally: torch.Tensor         # [jun_cap, 8]
    nbr_id: torch.Tensor        # [jun_cap, 8] neighbour node id (-1 absent)
    nbr_present: torch.Tensor   # [jun_cap, 8] membership
    nbr_isfw: torch.Tensor      # [jun_cap, 8] neighbour met canonically
    nbr_isjun: torch.Tensor     # [jun_cap, 8] neighbour is a junction
    nbr_joint_uid: torch.Tensor  # [jun_cap, 8] neighbour's unitig (-1)
    nbr_joint_fw: torch.Tensor  # [jun_cap, 8] queried neighbour state lies
                                # on the unitig's kept walk (GFA sign)


def materialize_sequences(dbg: DBG, chars, *, k: int, ucap: int,
                          char_cap: int) -> SeqPack:
    """Flat sequence codes of the first ``ucap`` unitig slots.
    ``chars`` = member_chars(dbg, k) ``[2M]``."""
    m = dbg.nodes.shape[0]
    dev = dbg.nodes.device
    head = dbg.unitig_head[:ucap]
    ulen = dbg.unitig_len[:ucap]
    circ = dbg.unitig_circular[:ucap]
    valid_u = torch.arange(ucap, device=dev) < dbg.num_unitigs
    seq_len = torch.where(valid_u, ulen + (k - 1), 0)
    offs = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                      torch.cumsum(seq_len, 0)])
    flat = torch.zeros((char_cap,), dtype=torch.uint8, device=dev)

    # Head k-mers: k scatters of the valid heads' chars.
    hk = dbg.nodes[(head >> 1).clamp(0, m - 1)][valid_u]
    ho = (head & 1)[valid_u]
    base_off = offs[:ucap][valid_u]
    for j in range(k):
        fw = kmer_mod.base_at(hk, j, k)
        rc = 3 - kmer_mod.base_at(hk, k - 1 - j, k)
        flat[base_off + j] = torch.where(ho == 0, fw, rc).to(torch.uint8)

    # Member chars: one scatter across all member states.
    uid = dbg.node_state_uid
    pos = dbg.node_state_pos
    memb = (uid >= 0) & (pos >= 1) & (uid < ucap)
    tgt = offs[uid.clamp(0, ucap - 1)] + pos + (k - 1)
    flat[tgt[memb]] = chars[memb].to(torch.uint8)
    return SeqPack(flat=flat, offs=offs, ulen=ulen, circular=circ)


def pack_junctions(dbg: DBG, cov, reach_jun, *, jun_cap: int) -> JunPack:
    m = dbg.nodes.shape[0]
    dev = dbg.nodes.device
    emit = dbg.is_junction_final & reach_jun
    found = torch.nonzero(emit).squeeze(1)[:jun_cap]
    jidx = torch.full((jun_cap,), m, dtype=torch.int64, device=dev)
    jidx[:found.shape[0]] = found
    jc = jidx.clamp(0, m - 1)

    nid = torch.cat([dbg.left_id, dbg.right_id], dim=1)[jc]
    pres = torch.cat([dbg.left_present, dbg.right_present], dim=1)[jc]
    isfw = torch.cat([dbg.left_isfw, dbg.right_isfw], dim=1)[jc]
    nidc = nid.clamp(0, m - 1)
    n_isjun = dbg.is_junction_final[nidc] & (nid >= 0)
    n_juid = torch.where(nid >= 0, dbg.joint_uid[nidc], -1)
    # A neighbour state is '+' iff it lies on the kept walk of its unitig
    # (reference's direct-vs-complement joint-map hit,
    # src/DeBruijnGraph.cpp:480-505, 520-541).
    s_n = nidc * 2 + torch.where(isfw, 0, 1)
    n_joint_fw = dbg.node_state_uid[s_n] >= 0
    cols = torch.arange(8, dtype=torch.int64, device=dev)
    return JunPack(
        node_id=jidx,
        kmers=dbg.nodes[jc],
        cov=cov.node_cov[jc],
        tally=cov.jun_tally[jc[:, None] * 8 + cols[None, :]],
        nbr_id=nid, nbr_present=pres, nbr_isfw=isfw,
        nbr_isjun=n_isjun, nbr_joint_uid=n_juid,
        nbr_joint_fw=n_joint_fw,
    )
