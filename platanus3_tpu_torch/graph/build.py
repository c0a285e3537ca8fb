"""Implicit de Bruijn graph -> junction/joint/unitig decomposition.

Port of ``platanus3_tpu/graph/build.py``, non-staged path.  The
decomposition rests on the same three facts:

* a node's class depends only on its 8-neighbourhood: junction <=>
  left degree != 1 or right degree != 1 (``SearchNode``'s branch,
  reference ``src/DeBruijnGraph.cpp:167``);
* maximal runs of (1,1) nodes are chains in a functional graph over
  DIRECTED STATES ``s = 2*node + orientation``, contracted by pointer
  doubling (``ptr = ptr[ptr]``) instead of a sequential walk;
* every chain appears once per direction, and a keep rule on the chain's
  minimum state dedups the mirror copy.

The JAX ``fori_loop`` / ``while_loop`` become Python loops of gathers;
loop 1 keeps its early exit at a fixpoint (one host read per round).
The staged path, ``chunked_gather`` and the compaction tiers work around
TPU-only faults and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from platanus3_tpu_torch.ops import bloom as bloom_mod
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import kmer as kmer_mod
from platanus3_tpu_torch.utils.profiling import timed_part

__all__ = ["DBG", "build_graph", "phantom_neighbors", "false_neighbours"]


class DBG(NamedTuple):
    """Array-form de Bruijn graph decomposition (leaves as in the JAX
    package; ids are int64).  ``M`` = node capacity, states
    ``s = 2*v + o`` with ``o = 0`` the canonical (stored) orientation.

    nodes:        ``[M, L]`` sorted canonical k-mers (padding past size)
    size:         0-dim valid node count
    left_present / right_present: ``[M, 4] bool`` neighbour membership
    left_id / right_id: ``[M, 4]`` node id of each neighbour's canonical
                  form, -1 if not in the node table
    left_isfw / right_isfw: ``[M, 4] bool`` neighbour's traversal form is
                  its canonical form
    is_junction:  ``[M] bool`` degree != (1,1)
    is_junction_final: ``[M] bool`` junction or lone chain node
    is_joint:     ``[M] bool`` end node of a kept chain
    joint_uid:    ``[M]`` unitig id a joint bounds, -1 otherwise
    node_state_uid / node_state_pos: ``[2M]`` per-state unitig
                  membership and position (-1 when not a member)
    state_next_id / state_next_o: ``[2M]`` raw rightward continuation
                  node id and the orientation it is met in
    unitig_head / unitig_tail: ``[M]`` head/tail STATE of each kept chain
    unitig_len:   ``[M]`` chain length in nodes
    unitig_circular: ``[M] bool`` chain was a junction-free cycle
    num_unitigs:  0-dim count of kept chains
    """

    nodes: torch.Tensor
    size: torch.Tensor
    left_present: torch.Tensor
    right_present: torch.Tensor
    left_id: torch.Tensor
    right_id: torch.Tensor
    left_isfw: torch.Tensor
    right_isfw: torch.Tensor
    is_junction: torch.Tensor
    is_junction_final: torch.Tensor
    is_joint: torch.Tensor
    joint_uid: torch.Tensor
    node_state_uid: torch.Tensor
    node_state_pos: torch.Tensor
    state_next_id: torch.Tensor
    state_next_o: torch.Tensor
    unitig_head: torch.Tensor
    unitig_tail: torch.Tensor
    unitig_len: torch.Tensor
    unitig_circular: torch.Tensor
    num_unitigs: torch.Tensor


def _neighbor_canon(nodes: torch.Tensor, k: int):
    """The 8 shifted neighbours of every node, canonicalised, column by
    column: yields ``(canon [M, L], is_fw [M])`` for left A/C/G/T then
    right A/C/G/T."""
    for shift_fn in (kmer_mod.shift_in_left, kmer_mod.shift_in_right):
        for b in range(4):
            yield kmer_mod.canonical(shift_fn(nodes, b, k), k)


def _neighbor_info(nodes, size, k, bf, use_exact, timer=None):
    """Membership / id / orientation of all 8 neighbours of every node.

    One (side, base) column at a time, which bounds the transient memory
    at a few ``[M, L]`` tensors (the JAX package does the same above
    2^22 nodes; the answers do not depend on the grouping).  In Bloom
    membership each column's query is timed as part ``graph.bloom_query``
    of ``timer``'s span (summed over the columns)."""
    m = nodes.shape[0]
    table = count_mod.KmerTable(nodes, torch.zeros_like(nodes[:, 0]), size)
    nid_cols, isfw_cols, pres_cols = [], [], []
    for canon, u_isfw in _neighbor_canon(nodes, k):
        nid_b = count_mod.lookup_id_join(table, canon, k=k)
        nid_cols.append(nid_b)
        isfw_cols.append(u_isfw)
        if use_exact:
            pres_cols.append(nid_b >= 0)
        else:
            with timed_part(timer, "graph.bloom_query"):
                pres_cols.append(bloom_mod.bloom_query(bf, canon, k))
    row_valid = torch.arange(m, device=nodes.device) < size
    nid = torch.stack(nid_cols, dim=1)
    all_isfw = torch.stack(isfw_cols, dim=1)
    pres = torch.stack(pres_cols, dim=1) & row_valid[:, None]
    return (pres[:, :4], nid[:, :4], all_isfw[:, :4],
            pres[:, 4:], nid[:, 4:], all_isfw[:, 4:])


def phantom_neighbors(dbg: DBG, k: int):
    """Canonical k-mers of Bloom-positive neighbours ABSENT from the node
    table: ``([M*8, L], [M*8] bool mask)``, row ``v*8 + col``.

    The reference enqueues every Bloom-positive neighbour during traversal
    (``src/DeBruijnGraph.cpp:167-179, 248-258``), so false positives become
    real nodes; the pipeline's Bloom closure merges these and rebuilds."""
    nodes = dbg.nodes
    m, l = nodes.shape
    all_canon = torch.stack([c for c, _ in _neighbor_canon(nodes, k)],
                            dim=1).reshape(m * 8, l)
    pres = torch.cat([dbg.left_present, dbg.right_present], dim=1)
    nid = torch.cat([dbg.left_id, dbg.right_id], dim=1)
    return all_canon, (pres & (nid < 0)).reshape(m * 8)


def false_neighbours(dbg: DBG) -> torch.Tensor:
    """How many rows :func:`phantom_neighbors` masks in (0-dim int64): the
    present neighbour columns whose k-mer is not in the node table.  In
    Bloom membership they are the filter's false positives among the
    nodes' neighbours."""
    return sum(((p & (i < 0)).sum() for p, i in (
        (dbg.left_present, dbg.left_id), (dbg.right_present, dbg.right_id))))


def _successor_states(nodes, size, lp, lid, lfw, rp, rid, rfw, *, k):
    """Degrees, junction mask and the per-state successor map."""
    m = nodes.shape[0]
    dev = nodes.device
    row_valid = torch.arange(m, device=dev) < size
    ldeg = lp.sum(dim=1)
    rdeg = rp.sum(dim=1)
    is_junction = ((ldeg != 1) | (rdeg != 1)) & row_valid
    chain_node = ~is_junction & row_valid

    # Palindrome flags of neighbours (orientation propagation, even k).
    if k % 2 == 0:
        def pal_of(ids):
            cols = []
            for b in range(4):
                idb = ids[:, b]
                cols.append(kmer_mod.is_palindrome(nodes[idb.clamp(0, m - 1)],
                                                   k) & (idb >= 0))
            return torch.stack(cols, dim=1)
        lpal, rpal = pal_of(lid), pal_of(rid)
    else:
        lpal = torch.zeros_like(lp)
        rpal = torch.zeros_like(rp)

    def pick(arr, b):
        return torch.gather(arr, 1, b[:, None])[:, 0]

    # argmax returns the first maximal index, as jnp.argmax does.
    rb = rp.to(torch.uint8).argmax(dim=1)
    lb = lp.to(torch.uint8).argmax(dim=1)
    r_id, r_fw = pick(rid, rb), pick(rfw, rb)
    l_id, l_fw, l_pal = pick(lid, lb), pick(lfw, lb), pick(lpal, lb)

    # Walking right in canonical orientation (o=0): the encountered form is
    # the raw right neighbour; next orientation 0 iff it is canonical.
    nxt0_id = r_id
    nxt0_o = torch.where(r_fw, 0, 1)
    # Walking right in reversed orientation (o=1): the encountered form is
    # revcomp(left neighbour); canonical iff the left neighbour is NOT
    # canonical (or is palindromic).
    nxt1_id = l_id
    nxt1_o = torch.where(l_fw & ~l_pal, 1, 0)

    def state_of(ids, orient):
        ok = chain_node & (ids >= 0) & chain_node[ids.clamp(0, m - 1)]
        return ok, ids * 2 + orient

    ok0, s0 = state_of(nxt0_id, nxt0_o)
    ok1, s1 = state_of(nxt1_id, nxt1_o)
    states = torch.arange(2 * m, dtype=torch.int64, device=dev)
    node_of_s = states >> 1
    odd = (states & 1) == 1
    nxt = torch.where(odd,
                      torch.where(ok1[node_of_s], s1[node_of_s], states),
                      torch.where(ok0[node_of_s], s0[node_of_s], states))
    chain_state = chain_node[node_of_s]
    nxt = torch.where(chain_state, nxt, states)
    state_next_id = torch.where(odd, nxt1_id[node_of_s], nxt0_id[node_of_s])
    state_next_o = torch.where(odd, nxt1_o[node_of_s], nxt0_o[node_of_s])
    return (is_junction, chain_node, chain_state, nxt, state_next_id,
            state_next_o)


def _finalize_chains(nxt_orig, chain_state, chain_node, is_junction,
                     cyc_head, cyc_min, tail, d2t):
    """Heads, mirror dedup, unitig slots, membership and joints.

    At a chain head h, ``cyc_min[h]`` is the min member state of h's chain
    and ``cyc_min[flip(tail[h])]`` the min member of the MIRROR chain."""
    m2 = chain_state.shape[0]
    m = m2 // 2
    dev = chain_state.device
    states = torch.arange(m2, dtype=torch.int64, device=dev)
    flip = states ^ 1
    fmin = cyc_min[tail ^ 1]

    # s has a predecessor iff its flip has a successor in the PRE-break
    # map; cycle heads are heads by construction.
    has_prev = chain_state & (nxt_orig[flip] != flip) & ~cyc_head
    is_head = chain_state & ~has_prev
    # Keep the copy whose min member is <= the mirror's; equal exactly for
    # a chain that is its own mirror, which '<=' keeps once.
    keep = is_head & (cyc_min <= fmin)
    n_nodes = d2t + 1

    # Lone chains (one node) are promoted to junctions
    # (reference src/DeBruijnGraph.cpp:212-216).
    lone_state = is_head & (d2t == 0)
    lone_node = lone_state[0::2] | lone_state[1::2]
    is_junction_final = is_junction | (chain_node & lone_node)

    real_head = keep & (d2t >= 1)
    uid_of_head = torch.cumsum(real_head.to(torch.int64), 0) - 1
    num_unitigs = real_head.sum()
    slots = uid_of_head[real_head]
    unitig_head = torch.full((m,), -1, dtype=torch.int64, device=dev)
    unitig_head[slots] = states[real_head]
    unitig_tail = torch.full((m,), -1, dtype=torch.int64, device=dev)
    unitig_tail[slots] = tail[real_head]
    unitig_len = torch.zeros((m,), dtype=torch.int64, device=dev)
    unitig_len[slots] = n_nodes[real_head]
    unitig_circular = torch.zeros((m,), dtype=torch.bool, device=dev)
    unitig_circular[slots] = cyc_head[real_head]

    # member -> head via the chain's unique tail state
    head_by_tail = torch.full((m2,), -1, dtype=torch.int64, device=dev)
    head_by_tail[tail[real_head]] = states[real_head]
    my_head = head_by_tail[tail]
    member = chain_state & (my_head >= 0)
    my_head_c = my_head.clamp(0, m2 - 1)
    uid = torch.where(member, uid_of_head[my_head_c], -1)
    pos = torch.where(member, d2t[my_head_c] - d2t, -1)

    # joints: end nodes of kept chains
    valid_u = torch.arange(m, device=dev) < num_unitigs
    uslot = torch.arange(m, dtype=torch.int64, device=dev)
    head_node = (unitig_head >> 1)[valid_u]
    tail_node = (unitig_tail >> 1)[valid_u]
    is_joint = torch.zeros((m,), dtype=torch.bool, device=dev)
    is_joint[head_node] = True
    is_joint[tail_node] = True
    joint_uid = torch.full((m,), -1, dtype=torch.int64, device=dev)
    joint_uid.scatter_reduce_(0, head_node, uslot[valid_u], reduce="amax")
    joint_uid.scatter_reduce_(0, tail_node, uslot[valid_u], reduce="amax")
    return (is_junction_final, is_joint, joint_uid, uid, pos, unitig_head,
            unitig_tail, unitig_len, unitig_circular, num_unitigs)


def build_graph(nodes: torch.Tensor, size, k: int,
                bf: bloom_mod.BloomFilter, use_exact: bool = False,
                timer=None) -> DBG:
    """Construct the decomposition from a sorted canonical node table.

    ``nodes``: ``[M, L]`` sorted unique canonical k-mers (0xFFFFFFFF
    padding past ``size``); ``bf`` is queried when ``use_exact`` is False,
    the queries timed as part ``graph.bloom_query`` of ``timer``'s span.
    """
    m = nodes.shape[0]
    dev = nodes.device
    size = torch.as_tensor(size, dtype=torch.int64, device=dev)
    rounds = max(1, int(2 * m).bit_length())

    lp, lid, lfw, rp, rid, rfw = _neighbor_info(nodes, size, k, bf,
                                                use_exact, timer)
    (is_junction, chain_node, chain_state, nxt, state_next_id,
     state_next_o) = _successor_states(nodes, size, lp, lid, lfw, rp, rid,
                                       rfw, k=k)
    states = torch.arange(2 * m, dtype=torch.int64, device=dev)

    # ---- cycle detection & breaking: loop 0 over the PRE-break map gives
    # each state's tail and the min reachable state (its cycle's min on a
    # cycle).  A fixed number of rounds, as the JAX fori_loop.
    tail0, cyc_min = nxt, states
    for _ in range(rounds):
        tail0, cyc_min = tail0[tail0], torch.minimum(cyc_min, cyc_min[tail0])
    cyclic = (nxt[tail0] != tail0) & chain_state
    cyc_head = cyclic & (cyc_min == states)
    # Break each cycle just before its (min-state) head.
    nxt_orig = nxt
    nxt = torch.where(cyclic & (nxt == cyc_min), states, nxt)
    del tail0, cyclic

    # ---- chains: loop 1 on the broken (acyclic) map gives tail and
    # distance to tail; it stops once a round changes no pointer.
    tail, d2t = nxt, (nxt != states).to(torch.int64)
    for _ in range(rounds):
        p2 = tail[tail]
        d2t = d2t + d2t[tail]
        done = bool(torch.equal(p2, tail))
        tail = p2
        if done:
            break
    del nxt
    (is_junction_final, is_joint, joint_uid, node_state_uid, node_state_pos,
     unitig_head, unitig_tail, unitig_len, unitig_circular,
     num_unitigs) = _finalize_chains(nxt_orig, chain_state, chain_node,
                                     is_junction, cyc_head, cyc_min, tail,
                                     d2t)
    return DBG(
        nodes=nodes, size=size,
        left_present=lp, right_present=rp,
        left_id=lid, right_id=rid,
        left_isfw=lfw, right_isfw=rfw,
        is_junction=is_junction,
        is_junction_final=is_junction_final,
        is_joint=is_joint, joint_uid=joint_uid,
        node_state_uid=node_state_uid, node_state_pos=node_state_pos,
        state_next_id=state_next_id, state_next_o=state_next_o,
        unitig_head=unitig_head, unitig_tail=unitig_tail,
        unitig_len=unitig_len, unitig_circular=unitig_circular,
        num_unitigs=num_unitigs,
    )
