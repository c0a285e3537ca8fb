"""Plain PyTorch reference of the assembly a job performs: reads -> GFA.

The reference of the configurations whose ``reference`` is ``debruijn``.

Written from the semantics of the platanus3 de Bruijn assembly, in plain
PyTorch (any device) and without anything of the program under test.  It
works on whole reads, not on the program's chunks, and on k-mers of up
to 32 bases held as a pair of 32-bit words ``(hi, lo)`` (``lo`` the last
16 bases, ``hi`` the bases before them), ordered by one int64 ``key``:

1. solidity: every short k-mer of every read is counted (canonical form,
   both strands merged); a k-mer at read position ``p`` is solid when the
   smallest count of the short k-mers inside it reaches the threshold;
2. nodes: the distinct canonical solid k-mers, in lexicographic order;
   each read's first solid k-mer is its seed;
3. graph: a node's neighbours are the nodes one base to its left or
   right; a node is a junction unless it has exactly one of each;
   maximal runs of the other nodes, walked over the directed states
   ``2*node + orientation``, are the straights (a straight of one node
   becomes a junction), each kept in the direction whose smallest state
   is smaller, numbered in the order of their first state;
4. coverage: each read position adds 1 to its node (2 to a palindrome),
   and the bases around a junction's occurrences tally its links;
5. seeds: only the straights and junctions connected to a seed's node
   are emitted;
6. GFA: ``S`` lines of the straights (``KC`` = length) and junctions
   (``KC`` = coverage times k), then an ``L`` line for each observed
   link of a junction to an emitted segment, then the self-links of
   circular straights.

Graph membership is exact.  A job with ``--membership bloom`` asks a
Bloom filter instead, whose false neighbours the platanus3 reference
would make nodes of coverage 0.  At the cells' fill (under 6 % of the
bits set, 10 probes) an ideal filter adds one a job with a chance below
1e-4, so the exact graph is the one to compare.

``node_key_bits`` (the control) identifies a node by a fingerprint of
that many bits of its key instead of the whole key, as a hash table of
fingerprints would: nodes with one fingerprint merge, and a neighbour
whose fingerprint matches a node's is taken for that node.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Assembly", "assemble", "reference"]

M32 = 0xFFFFFFFF
_OFF = 1 << 31
_BIG = 1 << 62
_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
BLOCK = 1 << 25     # read positions a step of the per-position passes


@dataclasses.dataclass
class Assembly:
    gfa: str                  # the whole GFA text, as a job writes it
    solid_nodes: int          # distinct solid canonical k-mers
    solid_positions: int      # read positions holding a solid k-mer
    straights: int
    junctions: int
    links: int


# ---- k-mers as (hi, lo) word pairs ---------------------------------------

def _split(k: int):
    lb = min(k, 16)
    return k - lb, lb          # bases in hi, bases in lo


def _words(codes, a: int, b: int, k: int):
    """Forward words of the k-mers starting at ``codes`` positions
    ``[a, b)`` (the array is padded past its end)."""
    hb, lb = _split(k)
    hi = torch.zeros(b - a, dtype=torch.int64, device=codes.device)
    lo = torch.zeros_like(hi)
    for i in range(hb):
        hi = (hi << 2) | codes[a + i:b + i]
    for i in range(lb):
        lo = (lo << 2) | codes[a + hb + i:b + hb + i]
    return hi, lo


def _rev32(v):
    """Reverse the 16 two-bit groups of each 32-bit word."""
    v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    return ((v << 16) | (v >> 16)) & M32


def _revcomp(hi, lo, k: int):
    rh, rl = _rev32(~lo & M32), _rev32(~hi & M32)
    s = 2 * (32 - k)
    if s == 0:
        return rh, rl
    if s < 32:
        return rh >> s, ((rl >> s) | (rh << (32 - s))) & M32
    return torch.zeros_like(rh), rh >> (s - 32)


def _key(hi, lo):
    """One int64 whose order is the k-mers' lexicographic order."""
    return (hi - _OFF) * (1 << 32) + lo


def _unkey(key):
    return (key >> 32) + _OFF, key & M32


def _canonical(hi, lo, k: int):
    """``(canonical key, is_fw, is_palindrome)``: forward wins ties."""
    kf = _key(hi, lo)
    kr = _key(*_revcomp(hi, lo, k))
    return torch.minimum(kf, kr), kf <= kr, kf == kr


def _shift_right(hi, lo, b: int, k: int):
    """Drop the first base, append ``b``."""
    hb, lb = _split(k)
    if hb == 0:
        return hi, ((lo << 2) | b) & ((1 << (2 * lb)) - 1)
    carry = lo >> 30
    return (((hi << 2) | carry) & ((1 << (2 * hb)) - 1),
            ((lo << 2) | b) & M32)


def _shift_left(hi, lo, b: int, k: int):
    """Drop the last base, prepend ``b``."""
    hb, lb = _split(k)
    if hb == 0:
        return hi, (lo >> 2) | (b << (2 * (lb - 1)))
    return (hi >> 2) | (b << (2 * (hb - 1))), (lo >> 2) | ((hi & 3) << 30)


def _base(hi, lo, j: int, k: int):
    q = 2 * (k - 1 - j)
    return (hi >> (q - 32)) & 3 if q >= 32 else (lo >> q) & 3


# ---- the node index: exact, or by fingerprint (the control) --------------

class _Index:
    """Node ids of canonical keys: ``nodes`` sorted; ``ids`` gives -1 for
    a key that is no node."""

    def __init__(self, solid_keys, fp_bits=None):
        self.fp_bits = fp_bits
        if fp_bits is None:
            self.nodes = torch.unique(solid_keys)
            return
        fp = self._fp(solid_keys)
        ufp, inv = torch.unique(fp, return_inverse=True)
        rep = torch.full(ufp.shape, _BIG, dtype=torch.int64,
                         device=fp.device)
        rep.scatter_reduce_(0, inv, solid_keys, reduce="amin")
        # Each fingerprint's node is its smallest k-mer; ids follow the
        # k-mers' order.
        self.nodes, order = torch.sort(rep)
        self.fps = ufp
        self.id_of_fp = torch.empty_like(order)
        self.id_of_fp[order] = torch.arange(order.shape[0],
                                            device=order.device)

    def _fp(self, keys):
        hi, lo = _unkey(keys)
        h = ((hi * 0x7FEB352D) ^ (lo * 0x68E31DA5)) >> 13
        return (h ^ (h >> 29)) & ((1 << self.fp_bits) - 1)

    def ids(self, keys):
        table = self.nodes if self.fp_bits is None else self.fps
        q = keys if self.fp_bits is None else self._fp(keys)
        if table.shape[0] == 0:
            return torch.full_like(keys, -1)
        at = torch.searchsorted(table, q).clamp(max=table.shape[0] - 1)
        hit = table[at] == q
        if self.fp_bits is not None:
            at = self.id_of_fp[at]
        return torch.where(hit, at, -1)


# ---- stages ---------------------------------------------------------------

class _Reads:
    def __init__(self, codes: np.ndarray, offs: np.ndarray, k: int, device):
        lens = np.diff(offs)
        if (lens < k).any():        # reads shorter than k are dropped
            keep = lens >= k
            codes = np.concatenate([codes[offs[i]:offs[i + 1]]
                                    for i in np.nonzero(keep)[0]] or
                                   [np.zeros(0, np.uint8)])
            offs = np.concatenate([[0], np.cumsum(lens[keep])])
        self.n = int(offs[-1])
        pad = np.zeros(k + 1, dtype=np.uint8)
        self.codes = torch.from_numpy(np.concatenate([codes, pad])).to(
            device).long()
        self.offs = torch.from_numpy(offs.astype(np.int64)).to(device)
        self.num_reads = offs.shape[0] - 1

    def blocks(self):
        for a in range(0, self.n, BLOCK):
            yield a, min(self.n, a + BLOCK)

    def span(self, a: int, b: int):
        """Read index, start and end of each position in ``[a, b)``."""
        pos = torch.arange(a, b, device=self.codes.device)
        rid = torch.searchsorted(self.offs, pos, right=True) - 1
        return pos, rid, self.offs[rid], self.offs[rid + 1]


def _short_counts(reads: _Reads, short_k: int):
    keys = []
    for a, b in reads.blocks():
        pos, _, _, end = reads.span(a, b)
        canon, _, _ = _canonical(*_words(reads.codes, a, b, short_k), short_k)
        keys.append(canon[pos + short_k <= end])
    keys = torch.sort(torch.cat(keys)).values
    return torch.unique_consecutive(keys, return_counts=True)


def _solid(reads: _Reads, k, short_k, cov_threshold):
    """Per block, the canonical keys of solid positions; the first solid
    position of each read; the number of solid positions."""
    uniq, counts = _short_counts(reads, short_k)
    w = k - short_k + 1
    dev = reads.codes.device
    first = torch.full((reads.num_reads,), _BIG, dtype=torch.int64,
                       device=dev)
    solid_keys, n_solid = [], 0
    for a, b in reads.blocks():
        pos, rid, _, end = reads.span(a, b)
        sk, _, _ = _canonical(*_words(reads.codes, a, b + w - 1, short_k),
                              short_k)
        at = torch.searchsorted(uniq, sk).clamp(max=uniq.shape[0] - 1)
        cnt = torch.where(uniq[at] == sk, counts[at], 0)
        del sk, at
        est = cnt[:b - a]
        for j in range(1, w):
            est = torch.minimum(est, cnt[j:j + b - a])
        solid = (pos + k <= end) & (est >= cov_threshold)
        del cnt, est
        canon, _, _ = _canonical(*_words(reads.codes, a, b, k), k)
        solid_keys.append(canon[solid])
        n_solid += int(solid.sum())
        first.scatter_reduce_(0, rid[solid], pos[solid], reduce="amin")
    del uniq, counts
    has_seed = first < _BIG
    seed_pos = first[has_seed]
    seeds = torch.zeros_like(seed_pos)
    for i in range(0, seed_pos.shape[0], BLOCK):
        p = seed_pos[i:i + BLOCK]
        hi = torch.zeros_like(p)
        lo = torch.zeros_like(p)
        hb, lb = _split(k)
        for j in range(hb):
            hi = (hi << 2) | reads.codes[p + j]
        for j in range(lb):
            lo = (lo << 2) | reads.codes[p + hb + j]
        seeds[i:i + BLOCK], _, _ = _canonical(hi, lo, k)
    return torch.cat(solid_keys), seeds, n_solid


@dataclasses.dataclass
class _Graph:
    m: int
    present: torch.Tensor    # [m, 8] left A,C,G,T then right A,C,G,T
    nid: torch.Tensor        # [m, 8] neighbour's node id, -1 if none
    isfw: torch.Tensor       # [m, 8] the neighbour is met in its canonical form
    jfinal: torch.Tensor     # [m] junction (after lone straights join them)
    uid: torch.Tensor        # [2m] straight of each state, -1 if none
    pos: torch.Tensor        # [2m] position on it
    head: torch.Tensor       # [u] first state of each straight
    length: torch.Tensor     # [u] nodes
    circular: torch.Tensor   # [u]
    joint_uid: torch.Tensor  # [m] straight a node ends (largest id), -1


def _neighbours(index: _Index, k: int):
    hi, lo = _unkey(index.nodes)
    nid, isfw = [], []
    for shift in (_shift_left, _shift_right):
        for b in range(4):
            canon, fw, _ = _canonical(*shift(hi, lo, b, k), k)
            nid.append(index.ids(canon))
            isfw.append(fw)
    return torch.stack(nid, 1), torch.stack(isfw, 1)


def _graph(index: _Index, k: int) -> _Graph:
    m = index.nodes.shape[0]
    dev = index.nodes.device
    nid, isfw = _neighbours(index, k)
    present = nid >= 0
    ldeg, rdeg = present[:, :4].sum(1), present[:, 4:].sum(1)
    chain = (ldeg == 1) & (rdeg == 1)
    node_rows = torch.arange(m, device=dev)
    # The one neighbour on each side of a chain node (first present base).
    lb = present[:, :4].to(torch.uint8).argmax(1)
    rb = 4 + present[:, 4:].to(torch.uint8).argmax(1)
    l_id, l_fw = nid[node_rows, lb], isfw[node_rows, lb]
    r_id, r_fw = nid[node_rows, rb], isfw[node_rows, rb]
    hi, lo = _unkey(index.nodes)
    _, _, pal = _canonical(hi, lo, k)
    l_pal = pal[l_id.clamp(min=0)] & (l_id >= 0)
    # Walking right from state 2v (canonical) meets the right neighbour;
    # from 2v+1 (reversed) the reverse complement of the left one.
    s0 = r_id * 2 + torch.where(r_fw, 0, 1)
    s1 = l_id * 2 + torch.where(l_fw & ~l_pal, 1, 0)
    ok0 = chain & (r_id >= 0) & chain[r_id.clamp(min=0)]
    ok1 = chain & (l_id >= 0) & chain[l_id.clamp(min=0)]
    states = torch.arange(2 * m, device=dev)
    nxt = torch.stack([torch.where(ok0, s0, states[0::2]),
                       torch.where(ok1, s1, states[1::2])], 1).reshape(-1)
    chain_state = chain.repeat_interleave(2)
    rounds = max(1, (2 * m).bit_length())
    # Cycles: the smallest state reachable, and the breaking of each cycle
    # just before its smallest state.
    tail0, cmin = nxt, states
    for _ in range(rounds):
        tail0, cmin = tail0[tail0], torch.minimum(cmin, cmin[tail0])
    cyclic = (nxt[tail0] != tail0) & chain_state
    cyc_head = cyclic & (cmin == states)
    broken = torch.where(cyclic & (nxt == cmin), states, nxt)
    tail, d2t = broken, (broken != states).long()
    while True:
        t2 = tail[tail]
        d2t = d2t + d2t[tail]
        if torch.equal(t2, tail):
            break
        tail = t2
    flip = states ^ 1
    has_prev = chain_state & (nxt[flip] != flip) & ~cyc_head
    is_head = chain_state & ~has_prev
    keep = is_head & (cmin <= cmin[tail ^ 1])
    lone = is_head & (d2t == 0)
    jfinal = ~chain | (lone[0::2] | lone[1::2])
    real = keep & (d2t >= 1)
    heads = states[real]
    uid_of = torch.cumsum(real.long(), 0) - 1
    head_by_tail = torch.full((2 * m,), -1, dtype=torch.int64, device=dev)
    head_by_tail[tail[heads]] = heads
    my_head = head_by_tail[tail]
    member = chain_state & (my_head >= 0)
    mh = my_head.clamp(min=0)
    uid = torch.where(member, uid_of[mh], -1)
    pos = torch.where(member, d2t[mh] - d2t, -1)
    u = heads.shape[0]
    ends = torch.cat([heads >> 1, tail[heads] >> 1])
    joint_uid = torch.full((m,), -1, dtype=torch.int64, device=dev)
    joint_uid.scatter_reduce_(0, ends, torch.arange(u, device=dev).repeat(2),
                              reduce="amax")
    return _Graph(m=m, present=present, nid=nid, isfw=isfw, jfinal=jfinal,
                  uid=uid, pos=pos, head=heads, length=d2t[heads] + 1,
                  circular=cyc_head[heads], joint_uid=joint_uid)


def _coverage(reads: _Reads, index: _Index, g: _Graph, k: int):
    dev = reads.codes.device
    cov = torch.zeros((g.m,), dtype=torch.int64, device=dev)
    tally = torch.zeros((g.m * 8,), dtype=torch.int64, device=dev)
    for a, b in reads.blocks():
        pos, _, start, end = reads.span(a, b)
        canon, fw, pal = _canonical(*_words(reads.codes, a, b, k), k)
        nid = torch.where(pos + k <= end, index.ids(canon), -1)
        hit = nid >= 0
        cov.index_add_(0, nid[hit], torch.where(pal, 2, 1)[hit])
        jun = hit & g.jfinal[nid.clamp(min=0)]
        prev = reads.codes[(pos - 1).clamp(min=0)]
        nxt = reads.codes[pos + k]
        left = jun & (pos > start)
        right = jun & (pos + k < end)
        col_p = torch.where(fw, prev, 7 - prev)
        col_n = torch.where(fw, 4 + nxt, 3 - nxt)
        for sel, col in ((left, col_p), (right, col_n)):
            idx = (nid * 8 + col)[sel]
            tally.index_add_(0, idx, torch.ones_like(idx))
    return cov, tally


def _components(src, tgt, v: int, dev):
    """Each vertex's smallest connected vertex, over undirected edges."""
    lab = torch.arange(v, device=dev)
    while True:
        m = torch.minimum(lab[src], lab[tgt])
        new = lab.clone()
        new.scatter_reduce_(0, src, m, reduce="amin")
        new.scatter_reduce_(0, tgt, m, reduce="amin")
        new = new[new]
        if torch.equal(new, lab):
            return lab
        lab = new


def _reach(index: _Index, g: _Graph, seeds):
    """Emitted junction nodes ``[m]`` and straights ``[u]``."""
    m, dev = g.m, index.nodes.device
    u = g.head.shape[0]

    def vertex(n):
        nc = n.clamp(min=0)
        su = torch.maximum(g.uid[2 * nc], g.uid[2 * nc + 1])
        vert = torch.where(g.jfinal[nc], nc, torch.where(su >= 0, m + su, -1))
        return torch.where(n >= 0, vert, -1)

    src = torch.arange(m, device=dev)[:, None].expand(m, 8)
    tgt = torch.where(g.present & g.jfinal[:, None], vertex(g.nid), -1)
    ok = tgt >= 0
    lab = _components(src[ok], tgt[ok], m + u, dev)
    sv = vertex(index.ids(seeds))
    reached = torch.zeros((m + u,), dtype=torch.bool, device=dev)
    reached[lab[sv[sv >= 0]]] = True
    reached = reached[lab]
    return reached[:m] & g.jfinal, reached[m:]


def _kmer_text(keys, k: int):
    hi, lo = _unkey(keys)
    cols = torch.stack([_base(hi, lo, j, k) for j in range(k)], 1)
    return _ASCII[cols.to(torch.uint8).cpu().numpy()]


def _straight_text(index, g: _Graph, emit_u, k: int):
    """Sequences of the emitted straights, in straight order."""
    dev = index.nodes.device
    u = g.head.shape[0]
    seq_len = g.length + (k - 1)
    offs = torch.zeros((u + 1,), dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(seq_len, 0)
    flat = torch.zeros((int(offs[-1]),), dtype=torch.uint8, device=dev)
    hi, lo = _unkey(index.nodes)
    # The first k-mer in its walking orientation, then one base a state:
    # the last base of the canonical form, or the complement of its first.
    hh, hl = hi[g.head >> 1], lo[g.head >> 1]
    rev = (g.head & 1) == 1
    rh, rl = _revcomp(hh, hl, k)
    hh, hl = torch.where(rev, rh, hh), torch.where(rev, rl, hl)
    for j in range(k):
        flat[offs[:-1] + j] = _base(hh, hl, j, k).to(torch.uint8)
    last = lo & 3
    firstb = _base(hi, lo, 0, k)
    char = torch.stack([last, 3 - firstb], 1).reshape(-1)
    memb = (g.uid >= 0) & (g.pos >= 1)
    at = offs[g.uid.clamp(min=0)] + g.pos + (k - 1)
    flat[at[memb]] = char[memb].to(torch.uint8)
    text = _ASCII[flat.cpu().numpy()].tobytes().decode()
    offs = offs.cpu().tolist()
    return [text[offs[i]:offs[i + 1]]
            for i in torch.nonzero(emit_u).squeeze(1).tolist()]


def _gfa(index: _Index, g: _Graph, cov, tally, emit_j, emit_u, k: int):
    u = g.head.shape[0]
    seqs = _straight_text(index, g, emit_u, k)
    uni_gfa = torch.cumsum(emit_u.long(), 0) * emit_u
    jun_gfa = torch.cumsum(emit_j.long(), 0) * emit_j
    jrows = torch.nonzero(emit_j).squeeze(1)
    lines = ["H\tVN:Z:1.0"]
    lines += [f"S\tStraight_{i + 1}\t{s}\tKC:i:{len(s)}"
              for i, s in enumerate(seqs)]
    kmers = _kmer_text(index.nodes[jrows], k)
    jcov = (cov[jrows] * k).tolist()
    lines += [f"S\tJunction_{i + 1}\t{row.tobytes().decode()}\tKC:i:{c}"
              for i, (row, c) in enumerate(zip(kmers, jcov))]
    # Links of each emitted junction, in junction then column order.
    n = g.nid[jrows]
    nc = n.clamp(min=0)
    t = tally.reshape(-1, 8)[jrows]
    to_jun = g.jfinal[nc]
    juid = torch.where(n >= 0, g.joint_uid[nc], -1)
    uok = (juid >= 0) & (juid < u)
    u_gid = uni_gfa[juid.clamp(0, max(u - 1, 0))] if u else \
        torch.zeros_like(n)
    gid = torch.where(to_jun, jun_gfa[nc], torch.where(uok, u_gid, 0))
    on_walk = g.uid[nc * 2 + torch.where(g.isfw[jrows], 0, 1)] >= 0
    sign_fw = torch.where(to_jun, g.isfw[jrows], on_walk)
    emit_l = (t != 0) & g.present[jrows] & (n >= 0) & (gid > 0)
    rr, dd = torch.nonzero(emit_l, as_tuple=True)
    ov = f"{k - 1}M"
    for r, d, j_, gi, fw in zip(rr.tolist(), dd.tolist(),
                                to_jun[rr, dd].tolist(), gid[rr, dd].tolist(),
                                sign_fw[rr, dd].tolist()):
        me = f"Junction_{r + 1}"
        name = f"Junction_{gi}" if j_ else f"Straight_{gi}"
        sign = "+" if fw else "-"
        lines.append(f"L\t{name}\t{sign}\t{me}\t+\t{ov}" if d < 4 else
                     f"L\t{me}\t+\t{name}\t{sign}\t{ov}")
    n_links = len(rr)
    for i in torch.nonzero(emit_u & g.circular).squeeze(1).tolist():
        name = f"Straight_{int(uni_gfa[i])}"
        lines.append(f"L\t{name}\t+\t{name}\t+\t{ov}")
        n_links += 1
    return "\n".join(lines) + "\n", len(seqs), len(jcov), n_links


def assemble(codes: np.ndarray, offs: np.ndarray, *, k: int, short_k: int,
             cov_threshold: int, device="cpu",
             node_key_bits=None) -> Assembly:
    """The GFA of the read set ``(codes, offs)`` (``traffic/gen.py``)."""
    if not 1 <= short_k <= k <= 32:
        raise ValueError(f"the reference takes short_k <= k <= 32, got "
                         f"k={k}, short_k={short_k}")
    reads = _Reads(codes, offs, k, device)
    solid_keys, seeds, n_solid = _solid(reads, k, short_k, cov_threshold)
    index = _Index(solid_keys, node_key_bits)
    del solid_keys
    g = _graph(index, k)
    cov, tally = _coverage(reads, index, g, k)
    del reads
    emit_j, emit_u = _reach(index, g, seeds)
    gfa, n_s, n_j, n_l = _gfa(index, g, cov, tally, emit_j, emit_u, k)
    return Assembly(gfa=gfa, solid_nodes=int(index.nodes.shape[0]),
                    solid_positions=n_solid, straights=n_s, junctions=n_j,
                    links=n_l)


def reference(codes, offs, params: dict, device="cpu",
              node_key_bits=None) -> Assembly:
    """``assemble`` with a configuration's ``params``
    (``configs/<name>.json``)."""
    return assemble(codes, offs, k=params["k"], short_k=params["short_k"],
                    cov_threshold=params["cov_threshold"], device=device,
                    node_key_bits=node_key_bits)
