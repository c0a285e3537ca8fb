"""GFA 1.0 output from compact device-emitted packs.

Reproduces the reference's output contract (``DeBruijnGraph::PrintGraph``,
reference ``src/DeBruijnGraph.cpp:451-544``):

* header ``H  VN:Z:1.0``
* ``S`` line per straight (unitig): name ``Straight_<id>``, sequence, tag
  ``KC:i:<len(sequence)>`` (yes -- the reference writes the LENGTH here,
  ``:459-461``);
* ``S`` line per junction: name ``Junction_<id>``, k-mer string, tag
  ``KC:i:<coverage * k>`` (``:463-465``);
* ``L`` lines emitted from junctions only, one per direction whose
  observed tally is > 0 AND whose neighbor is membership-recorded
  (``:470-473, 509-512``), overlap ``(k-1)M``; target resolution order
  junction -> joint(straight); the sign is '+' when the neighbor was
  found under its stored orientation and '-' under its reverse complement
  (``:486-505, 526-541``).  Joints are never emitted as segments and
  straight-straight links cannot occur.

Differences by design: ids are dense and deterministic (the reference's
depend on thread scheduling; SURVEY.md §4 bans comparing them); stored
orientation is the canonical form, so signs/sequences may be mirrored --
isomorphic graphs up to reverse complement.  Circular unitigs (which
would hang the reference's walker) get a self-``L`` line.

All inputs are numpy views of the compact packs built on device by
``graph/emit.py`` -- host work and transfer are proportional to the
OUTPUT size, not the graph capacity.  Port of ``platanus3_tpu/io/gfa.py``
(host numpy, unchanged).
"""

from __future__ import annotations

import numpy as np

from platanus3_tpu_torch.ops import kmer as kmer_mod

__all__ = ["gfa_lines", "sequences_from_pack", "contig_fasta_lines",
           "write_contig_fasta"]

_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def sequences_from_pack(seq_pack, num_unitigs: int, k: int):
    """Flat code array -> list of unitig strings (index = unitig id)."""
    flat = _ASCII[np.asarray(seq_pack.flat)]
    offs = np.asarray(seq_pack.offs)
    return [flat[offs[u] : offs[u + 1]].tobytes().decode()
            for u in range(num_unitigs)]


def gfa_lines(jun_pack, seq_pack, reach_uni, num_unitigs: int, m: int,
              k: int, seqs=None):
    """Render GFA lines from compact packs.

    jun_pack / seq_pack: numpy pytrees (graph/emit.py); reach_uni: [>=U]
    bool; ``m`` = node capacity (invalid junction sentinel).
    """
    if seqs is None:
        seqs = sequences_from_pack(seq_pack, num_unitigs, k)
    reach_uni = np.asarray(reach_uni)
    circular = np.asarray(seq_pack.circular)

    emit_u = (reach_uni[:num_unitigs] if num_unitigs else
              np.zeros(0, bool))
    uni_gfa = np.full(max(num_unitigs, 1), -1, dtype=np.int64)
    uni_nodes = np.nonzero(emit_u)[0]
    uni_gfa[uni_nodes] = np.arange(1, len(uni_nodes) + 1)

    node_id = np.asarray(jun_pack.node_id)
    jvalid = node_id < m
    jun_rows = np.nonzero(jvalid)[0]
    # node id -> 1-based junction GFA id, as an array (a dict would cost
    # a Python op per link candidate -- millions on repeat-rich graphs).
    jun_gfa_arr = np.zeros(m + 1, dtype=np.int64)
    jun_gfa_arr[node_id[jun_rows]] = np.arange(1, len(jun_rows) + 1)

    lines = ["H\tVN:Z:1.0"]

    for u in uni_nodes:
        lines.append(
            f"S\tStraight_{uni_gfa[u]}\t{seqs[u]}\tKC:i:{len(seqs[u])}")

    jun_strs = (kmer_mod.decode_kmers_np(
        np.asarray(jun_pack.kmers)[jun_rows], k) if len(jun_rows) else [])
    cov = np.asarray(jun_pack.cov)
    for i, (r, s) in enumerate(zip(jun_rows, jun_strs)):
        lines.append(
            f"S\tJunction_{i + 1}\t{s}\tKC:i:{int(cov[r]) * k}")

    tally = np.asarray(jun_pack.tally)[jun_rows]           # [J, 8]
    nbr_id = np.asarray(jun_pack.nbr_id)[jun_rows]
    nbr_present = np.asarray(jun_pack.nbr_present)[jun_rows]
    nbr_isfw = np.asarray(jun_pack.nbr_isfw)[jun_rows]
    nbr_isjun = np.asarray(jun_pack.nbr_isjun)[jun_rows]
    nbr_juid = np.asarray(jun_pack.nbr_joint_uid)[jun_rows]
    nbr_jfw = np.asarray(jun_pack.nbr_joint_fw)[jun_rows]

    ov = f"{k - 1}M"
    # Vectorized link gating (the python per-(junction, direction) loop
    # was O(8J) interpreter work -- minutes at chromosome-scale junction
    # counts); only actually-emitted links reach the string loop.
    nid_c = np.clip(nbr_id, 0, m)
    cand = (tally != 0) & nbr_present & (nbr_id >= 0)
    juid_c = np.clip(nbr_juid, 0, max(num_unitigs - 1, 0))
    uok = ((nbr_juid >= 0) & (nbr_juid < num_unitigs)
           & (uni_gfa[juid_c] > 0)) if num_unitigs else np.zeros_like(cand)
    jok = jun_gfa_arr[nid_c] > 0
    emit_l = cand & np.where(nbr_isjun, jok, uok)
    rr, dd = np.nonzero(emit_l)
    isj = nbr_isjun[rr, dd]
    gid = np.where(isj, jun_gfa_arr[nid_c[rr, dd]],
                   uni_gfa[juid_c[rr, dd]])
    sign_fw = np.where(isj, nbr_isfw[rr, dd], nbr_jfw[rr, dd])
    for i, d, j_, g, fw in zip(rr.tolist(), dd.tolist(), isj.tolist(),
                               gid.tolist(), sign_fw.tolist()):
        me = f"Junction_{i + 1}"
        name = (f"Junction_{g}" if j_ else f"Straight_{g}")
        # Junctions are stored canonically: '+' iff the queried neighbor
        # form is canonical.  Straights are stored in their kept-walk
        # orientation: '+' iff the queried neighbor state is on that
        # walk.
        sign = "+" if fw else "-"
        if d < 4:   # left direction: neighbor -> junction
            lines.append(f"L\t{name}\t{sign}\t{me}\t+\t{ov}")
        else:       # right direction: junction -> neighbor
            lines.append(f"L\t{me}\t+\t{name}\t{sign}\t{ov}")

    for u in uni_nodes:
        if circular[u]:
            name = f"Straight_{uni_gfa[u]}"
            lines.append(f"L\t{name}\t+\t{name}\t+\t{ov}")

    return lines


def contig_fasta_lines(gfa, min_len: int = 0, include_junctions: bool = False):
    """Contig FASTA records derived from rendered GFA ``S`` lines.

    The reference emits only GFA (its consensus/FASTA stage is absent,
    ``README.md:1-3``); this framework additionally exports the assembled
    unitigs as contigs.  Deriving from the S lines keeps the record set
    identical to the graph output across all assembly modes (single-shot,
    streaming, multi-k).  Names and order follow the GFA segment names;
    headers carry the length and the ``KC`` tag.
    """
    out = []
    for line in gfa:
        if not line.startswith("S\t"):
            continue
        _, name, seq, tag = line.split("\t", 3)
        if not include_junctions and not name.startswith("Straight_"):
            continue
        if len(seq) < min_len:
            continue
        out.append(f">{name} length={len(seq)} {tag}")
        out.append(seq)
    return out


def write_contig_fasta(path, gfa, min_len: int = 0,
                       include_junctions: bool = False) -> int:
    """Write contigs (see :func:`contig_fasta_lines`); returns #records."""
    lines = contig_fasta_lines(gfa, min_len, include_junctions)
    with open(path, "w") as f:
        if lines:
            f.write("\n".join(lines) + "\n")
    return len(lines) // 2
