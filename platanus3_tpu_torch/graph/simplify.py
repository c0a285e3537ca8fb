"""Graph simplification: tip clipping and bubble popping.

Copy of ``platanus3_tpu/graph/simplify.py`` (host numpy, kept here so the
port imports nothing of the JAX package).  It reads the DBG leaves as
numpy arrays; the port's ids are int64 where the JAX package's are int32,
which changes no value.  Its bubble rule pairs arms by junction ids alone,
as the JAX package's does, so it also pops the loop arm of a tandem array
longer than k (ROADMAP.md Queue 3).

NEW capability with no reference counterpart (the reference stops at the
raw junction/unitig graph; SURVEY.md notes tip clipping and bubble popping
as required new work, §7 layer 5 / BASELINE configs 3-4).

Definitions (velvet/SPAdes-style, expressed on the contracted graph):

* TIP: a unitig whose sequence is short (<= ``tip_max_len``, default 2k)
  and whose far end is DEAD -- the bounding junction has zero continuations
  on the side away from the unitig.  Islands (dead at both ends) are kept.

* BUBBLE: two or more unitigs whose bounding junction pairs coincide
  (unordered) and whose lengths are within 20%; all but the
  highest-coverage arm are popped.

Simplification DECISIONS are made host-side on the small contracted-graph
arrays (O(U + M) data); the expensive consequence -- rebuilding the graph
without the dropped k-mers and re-contracting chains -- runs back on
device with exact membership (after deletion the Bloom filter no longer
describes the k-mer set, so adjacency switches to node-table lookups).
"""

from __future__ import annotations

import numpy as np

__all__ = ["unitig_coverage", "tip_mask", "bubble_mask",
           "node_keep_mask", "endpoint_junctions"]


def unitig_coverage(dbg_np, node_cov: np.ndarray) -> np.ndarray:
    """Mean member-node coverage per unitig ([U] float)."""
    num_u = int(dbg_np.num_unitigs)
    uid = np.asarray(dbg_np.node_state_uid)  # flat [2M]
    m2 = uid.shape[0]
    covs = np.repeat(np.asarray(node_cov), 2)
    tot = np.zeros(max(num_u, 1), dtype=np.float64)
    cnt = np.zeros(max(num_u, 1), dtype=np.int64)
    sel = uid >= 0
    np.add.at(tot, uid[sel], covs[sel])
    np.add.at(cnt, uid[sel], 1)
    return tot / np.maximum(cnt, 1)


def endpoint_junctions(dbg_np):
    """Per-unitig far-junction info.

    Returns ``(head_j, head_far_deg, tail_j, tail_far_deg)`` each [U]:
    the junction node id beyond each end (-1 if absent) and that
    junction's degree on its FAR side (away from the unitig).
    """
    num_u = int(dbg_np.num_unitigs)
    heads = np.asarray(dbg_np.unitig_head[:num_u])
    tails = np.asarray(dbg_np.unitig_tail[:num_u])
    nxt_id = np.asarray(dbg_np.state_next_id)     # flat [2M], by state
    nxt_o = np.asarray(dbg_np.state_next_o)
    ldeg = np.asarray(dbg_np.left_present).sum(1)
    rdeg = np.asarray(dbg_np.right_present).sum(1)

    def far(states):
        """Continue past `states` rightward -> (junction id, far degree)."""
        j = nxt_id[states]
        jo = nxt_o[states]
        jc = np.clip(j, 0, len(ldeg) - 1)
        # Arriving rightward, the junction's far side is its encountered
        # right: canonical right when encountered forward, left otherwise.
        fdeg = np.where(jo == 0, rdeg[jc], ldeg[jc])
        fdeg = np.where(j >= 0, fdeg, 0)
        return j, fdeg

    # Beyond the tail: straight ahead.  Beyond the head: rightward from the
    # flipped head state.
    tail_j, tail_far = far(tails)
    head_j, head_far = far(heads ^ 1)
    return head_j, head_far, tail_j, tail_far


def tip_mask(dbg_np, k: int, tip_max_len: int = 0,
             ucov: np.ndarray | None = None,
             node_cov: np.ndarray | None = None,
             cov_ratio: float = 0.0) -> np.ndarray:
    """[U] bool: unitigs to clip as tips.

    A one-dead-end unitig is clipped when it is short
    (``seq_len <= tip_max_len``), OR -- with ``cov_ratio > 0`` -- when its
    mean coverage is dominated by the junction it hangs off
    (``cov_ratio * ucov <= node_cov[junction]``, length-bounded at
    ``4*tip_max_len`` so genuine low-coverage contigs survive).  The
    coverage rule catches error tips longer than 2k that a pure length
    cutoff misses (SPAdes-style relative-coverage tip condition).
    """
    num_u = int(dbg_np.num_unitigs)
    if num_u == 0:
        return np.zeros(0, bool)
    if tip_max_len <= 0:
        tip_max_len = 2 * k
    seq_len = np.asarray(dbg_np.unitig_len[:num_u]) + k - 1
    circ = np.asarray(dbg_np.unitig_circular[:num_u])
    head_j, head_far, tail_j, tail_far = endpoint_junctions(dbg_np)
    dead_head = (head_j < 0) | (head_far == 0)
    dead_tail = (tail_j < 0) | (tail_far == 0)
    is_tip = (dead_head ^ dead_tail) & ~circ
    clip = is_tip & (seq_len <= tip_max_len)
    if cov_ratio > 0 and ucov is not None and node_cov is not None:
        att_j = np.where(dead_head, tail_j, head_j)  # the live end
        att_cov = np.asarray(node_cov)[np.clip(att_j, 0, None)]
        weak = (cov_ratio * ucov <= att_cov) & (att_j >= 0)
        clip |= is_tip & weak & (seq_len <= 4 * tip_max_len)
    return clip


def bubble_mask(dbg_np, ucov: np.ndarray, k: int,
                len_ratio: float = 1.2) -> np.ndarray:
    """[U] bool: unitigs to pop as bubble arms (keep best per group).

    Fully vectorized: arms are grouped by their unordered bounding
    junction pair with one lexsort (no per-group Python iteration --
    O(U log U) total, chromosome-scale safe); within a group the
    highest-coverage arm wins and every other arm whose length is within
    ``len_ratio`` of the winner's is popped.
    """
    num_u = int(dbg_np.num_unitigs)
    if num_u == 0:
        return np.zeros(0, bool)
    head_j, head_far, tail_j, tail_far = endpoint_junctions(dbg_np)
    seq_len = np.asarray(dbg_np.unitig_len[:num_u]) + k - 1
    circ = np.asarray(dbg_np.unitig_circular[:num_u])

    a = np.minimum(head_j, tail_j)
    b = np.maximum(head_j, tail_j)
    valid = (head_j >= 0) & (tail_j >= 0) & ~circ & (a != b)
    drop = np.zeros(num_u, bool)
    idx = np.nonzero(valid)[0]
    if idx.size < 2:
        return drop
    # group-major order; within a group best arm first (cov desc, id asc)
    order = idx[np.lexsort((idx, -np.asarray(ucov)[idx], b[idx], a[idx]))]
    ga, gb = a[order], b[order]
    new_grp = np.empty(order.size, bool)
    new_grp[0] = True
    new_grp[1:] = (ga[1:] != ga[:-1]) | (gb[1:] != gb[:-1])
    gid = np.cumsum(new_grp) - 1
    best_u = order[np.nonzero(new_grp)[0]][gid]   # group winner, per arm
    ln, bl = seq_len[order], seq_len[best_u]
    lo, hi = np.minimum(ln, bl), np.maximum(ln, bl)
    drop[order[~new_grp & (hi <= lo * len_ratio)]] = True
    return drop


def node_keep_mask(dbg_np, drop_unitigs: np.ndarray) -> np.ndarray:
    """[M] bool node keep mask after dropping the flagged unitigs.

    Every member node of a dropped unitig is deleted; bounding junctions
    stay (re-contraction may absorb them into neighboring chains).
    """
    m = dbg_np.nodes.shape[0]
    size = int(dbg_np.size)
    keep = np.arange(m) < size
    if drop_unitigs.size == 0 or not drop_unitigs.any():
        return keep
    uid = np.asarray(dbg_np.node_state_uid).reshape(m, 2)  # host-side view
    dropped = np.zeros(int(dbg_np.num_unitigs) + 1, bool)
    dropped[: drop_unitigs.size] = drop_unitigs
    member_dropped = dropped[np.clip(uid, 0, len(dropped) - 1)] & (uid >= 0)
    keep &= ~member_dropped.any(axis=1)
    return keep


def decide_drops(dbg_np, node_cov_np, config):
    """One simplification round's decision: node keep mask, or None when
    nothing to drop.  Shared by the single-shot pipeline and the
    streaming pipeline (which re-accumulates coverage slice-wise after
    each rebuild)."""
    num_u = int(dbg_np.num_unitigs)
    drop = np.zeros(num_u, bool)
    ucov = None
    tip_cov_ratio = getattr(config, "tip_cov_ratio", 0.0)
    if (config.pop_bubbles or tip_cov_ratio > 0) and num_u:
        ucov = unitig_coverage(dbg_np, np.asarray(node_cov_np))
    if config.clip_tips:
        drop |= tip_mask(dbg_np, config.k, config.tip_max_len,
                         ucov=ucov, node_cov=node_cov_np,
                         cov_ratio=tip_cov_ratio)
    if config.pop_bubbles:
        drop |= bubble_mask(dbg_np, ucov, config.k,
                            len_ratio=getattr(config, "bubble_len_ratio",
                                              1.2))
    if not drop.any():
        return None, 0
    return node_keep_mask(dbg_np, drop), int(drop.sum())
