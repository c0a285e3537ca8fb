"""End-to-end single-shot assembly pipeline.

Port of ``platanus3_tpu/pipeline.py`` (single-shot ``assemble``, at any
k), with the same stage boundaries and capacities, so that every array
compares one to one with the JAX package:

  stage 1 (device): short-k count -> window-min solidity -> solid node
            table, per-position node ids, per-read seed k-mers; with
            ``extra_solid`` (multi-k re-seeding, ``graph/multik.py``) the
            k-mers of those sequences are merged into the table
  compaction: the node table is cut to ``_graph_cap(num_nodes)`` rows
  Bloom build (Bloom membership only): the distinct nodes go into the
            packed filter through ``ops/bloom.bloom_add`` -- on a GPU the
            ``bloom_set_bits`` CUDA kernel
  stage 2 (device): graph decomposition; in Bloom mode the closure adds
            filter-positive neighbour k-mers as nodes and rebuilds
  stage 3 (device): coverage, junction tallies, seed reachability
  simplification (``clip_tips`` / ``pop_bubbles``): tips and bubbles
            are chosen on the host (``graph/simplify.py``), the graph is
            rebuilt without them with exact membership, and stage 3 runs
            again, for ``simplify_rounds`` rounds or to the fixpoint
  stage 4 (device -> host): emission packs, GFA rendering

Not ported yet, each raising ``NotImplementedError`` with its
``ROADMAP.md`` Queue 1 item: checkpoints, the mesh, tracing (streaming
is a separate entry point, ``--streaming`` in the CLI).
The TPU-only staged paths are not ported at all.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from platanus3_tpu_torch.config import AssemblyConfig
from platanus3_tpu_torch.graph import build as build_mod
from platanus3_tpu_torch.graph import coverage as cov_mod
from platanus3_tpu_torch.graph import emit as emit_mod
from platanus3_tpu_torch.graph import reach as reach_mod
from platanus3_tpu_torch.graph import sequence as seq_mod
from platanus3_tpu_torch.graph import simplify as simp_mod
from platanus3_tpu_torch.io import gfa as gfa_mod
from platanus3_tpu_torch.io import reads as reads_mod
from platanus3_tpu_torch.ops import bloom as bloom_mod
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import kmer as kmer_mod
from platanus3_tpu_torch.ops import solid as solid_mod
from platanus3_tpu_torch.utils.logging import PipelineLog
from platanus3_tpu_torch.utils.profiling import StageTimer

__all__ = ["assemble", "AssemblyResult"]

_PAD = kmer_mod.MASK32


@dataclasses.dataclass
class AssemblyResult:
    gfa_lines: list
    straight_seqs: list          # unitig id -> sequence (kept orientation)
    dbg: object                  # DBG of tensors
    cov: object                  # CoverageResult
    reach_jun: object
    reach_uni: object
    num_nodes: int
    num_junctions: int
    num_straights: int
    stats: dict


def _unsupported(config: AssemblyConfig):
    """The first option of ``config`` the port does not run yet."""
    if config.checkpoint_dir:
        return "checkpoints (ROADMAP.md Queue 1 item 2)"
    if config.trace_dir:
        return "trace_dir: no torch.profiler trace yet (ROADMAP.md Queue 1 " \
               "item 9)"
    return None


def _stage1(packed, valid_len, read_id, start, read_len, cov_threshold, *,
            k, short_k, num_reads):
    result = solid_mod.solid_kmers(
        (packed, valid_len, read_id, start, read_len), k, short_k,
        cov_threshold, need_short_table=False)
    seed_fw, has_seed = solid_mod.first_solid_per_read(
        result, read_id, start, num_reads)
    c, pk, l = result.canon.shape
    # One sort yields the node table AND every position's node id; the
    # node table's counts are never read (coverage is stage 3's).
    node_table, nid = count_mod.count_solid_with_ids(
        result.canon.reshape(-1, l), result.owned.reshape(-1),
        (result.is_solid & result.owned).reshape(-1), k=k,
        want_counts=False)
    return node_table, seed_fw, has_seed, nid.reshape(c, pk)


def _extra_solid_table(seqs, config, device):
    """K-mer table and seed k-mers of sequences taken as solid whatever
    their read coverage (multi-k re-seeding, ``graph/multik.py``): every
    k-mer of ``seqs`` becomes a node.  Returns ``(KmerTable, seed_fw)``."""
    k = config.k
    eb = reads_mod.reads_from_strings(seqs, k, config.chunk_len)

    def dev(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)

    bases = kmer_mod.unpack_bases(dev(eb.packed))
    fw, valid = kmer_mod.extract_kmers(bases, dev(eb.valid_len), k)
    canon, _ = kmer_mod.canonical(fw, k)
    pk = fw.shape[1]
    del fw, bases
    owned = solid_mod.owned_mask(dev(eb.start), dev(eb.read_len), eb.stride,
                                 pk, k, k) & valid
    l = canon.shape[-1]
    tab = count_mod.count_kmers(canon.reshape(-1, l), owned.reshape(-1), k=k)
    seed = dev(kmer_mod.encode_kmers_np([s[:k] for s in seqs if len(s) >= k]))
    return tab, seed


def _bloom_from_nodes(nodes, size, bf, *, k):
    """Insert the valid prefix of the compacted node table into the
    packed filter: exactly the distinct solid canonical k-mers."""
    rows = nodes.shape[0]
    mask = torch.arange(rows, device=nodes.device) < size
    return bloom_mod.bloom_add(bf, nodes, k, mask=mask)


def run_stage2(nodes, size, bf, *, k, use_exact):
    return build_mod.build_graph(nodes, size, k, bf, use_exact=use_exact)


def _stage3(dbg, packed, valid_len, start, read_len, prev_base, next_base,
            seed_fw, has_seed, nid, *, k):
    bases = kmer_mod.unpack_bases(packed)
    cov = cov_mod.count_coverage(dbg, k, bases, valid_len, start, read_len,
                                 prev_base, next_base, nid=nid)
    del bases
    reach_jun, reach_uni = reach_mod.reachable(dbg, seed_fw, has_seed, k)
    chars = seq_mod.member_chars(dbg, k)
    return cov, reach_jun, reach_uni, chars


def _n50(lengths) -> int:
    """The largest length L such that sequences of length >= L hold at
    least half of the total."""
    total, acc = sum(lengths), 0
    for x in sorted(lengths, reverse=True):
        acc += x
        if 2 * acc >= total:
            return x
    return 0


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


_GRAPH_CAP_POW2_MAX = 1 << 22
_GRAPH_CAP_STEP = 1 << 20


def _graph_cap(n: int) -> int:
    """Node capacity for the graph stage: a power of two up to 2^22
    nodes, above that the next multiple of 2^20 (as the JAX package)."""
    p = max(8, _next_pow2(n))
    if p <= _GRAPH_CAP_POW2_MAX:
        return p
    return min(p, -(-int(n) // _GRAPH_CAP_STEP) * _GRAPH_CAP_STEP)


def _pad_table_keys(keys, size: int, cap: int):
    rows, lanes = keys.shape
    if cap <= rows:
        return keys[:cap]
    pad = torch.full((cap - rows, lanes), _PAD, dtype=keys.dtype,
                     device=keys.device)
    return torch.cat([keys, pad], dim=0)


def _expand_bloom_closure(dbg, nodes, size, bf, config, log):
    """Bloom-membership closure: add filter-positive neighbour k-mers as
    nodes until fixpoint (or ``bloom_expand_rounds``), rebuilding the
    graph each round -- false positives become coverage-0 nodes as in the
    reference (``src/DeBruijnGraph.cpp:167-179, 248-258``).

    Returns ``(dbg, nodes, size, rounds_that_added_nodes)``."""
    grown = 0
    for rnd in range(max(0, config.bloom_expand_rounds)):
        canon, mask = build_mod.phantom_neighbors(dbg, config.k)
        n_extra = int(mask.sum())
        if n_extra == 0:
            break
        grown += 1
        extra = count_mod.count_kmers(canon, mask, k=config.k)
        del canon, mask
        base = count_mod.KmerTable(nodes, torch.zeros_like(nodes[:, 0]),
                                   size)
        merged = count_mod.merge_tables(base, extra)
        del extra, base
        n_new = int(merged.size)
        nodes = _pad_table_keys(merged.keys, n_new, _graph_cap(n_new))
        size = torch.tensor(n_new, dtype=torch.int64, device=nodes.device)
        del merged, dbg
        dbg = run_stage2(nodes, size, bf, k=config.k, use_exact=False)
        log.write(f"bloom closure round {rnd + 1}: {n_extra} phantom "
                  f"neighbor k-mers -> {n_new} nodes")
    return dbg, nodes, size, grown


# The DBG leaves the simplification decision reads on the host.
_SIMPLIFY_LEAVES = ("size", "left_present", "right_present",
                    "node_state_uid", "state_next_id", "state_next_o",
                    "unitig_head", "unitig_tail", "unitig_len",
                    "unitig_circular", "num_unitigs")


def _simplify(dbg, stage3, nid, bf, config, log, run_stage3, timer):
    """Tip clipping / bubble popping rounds after stage 3 (``stage3`` is
    its outputs): the drop decision on the host
    (``graph/simplify.decide_drops``), then the graph rebuilt from the
    kept nodes with EXACT membership (after a deletion the Bloom filter no
    longer describes the node set) and stage 3 run again.  Kept nodes keep
    their lexicographic order, so stage 1's node ids remap by rank among
    the kept rows.  Each round's parts are spans of ``timer``:
    ``simplify.to_host`` (the DBG leaves and coverage to numpy),
    ``simplify.decide``, ``simplify.stage2`` (the kept keys and the
    rebuild) and ``simplify.stage3``.  Returns ``(dbg, stage-3 outputs,
    unitigs dropped)``."""
    rounds = config.simplify_rounds if config.simplify_rounds > 0 else 100
    dropped = 0
    for rnd in range(rounds):
        dbg_np = dbg._replace(**{f: getattr(dbg, f).cpu().numpy()
                                 for f in _SIMPLIFY_LEAVES})
        node_cov = stage3[0].node_cov.cpu().numpy()
        timer.part("simplify.to_host")
        keep, n_drop = simp_mod.decide_drops(dbg_np, node_cov, config)
        timer.part("simplify.decide")
        if keep is None:
            break
        dropped += n_drop
        keep = torch.from_numpy(keep).to(dbg.nodes.device)
        kept = dbg.nodes[keep]
        n_keep = kept.shape[0]
        nodes = _pad_table_keys(kept, n_keep, _graph_cap(n_keep))
        size = torch.tensor(n_keep, dtype=torch.int64, device=nodes.device)
        del dbg, kept, stage3
        dbg = run_stage2(nodes, size, bf, k=config.k, use_exact=True)
        timer.part("simplify.stage2")
        if nid is not None:
            remap = torch.where(keep, torch.cumsum(keep, 0) - 1, -1)
            nid = torch.where(nid >= 0, remap[nid.clamp(min=0)], -1)
        stage3 = run_stage3(dbg, nid)
        timer.part("simplify.stage3")
        log.write(f"simplify round {rnd + 1}: dropped {n_drop} unitigs, "
                  f"{n_keep} nodes left")
    return dbg, stage3, dropped


def _emit_output(dbg, cov, reach_jun, reach_uni, chars, k):
    """Stage 4: compact emission packs on the device, GFA on the host."""
    num_u = int(dbg.num_unitigs)
    n_jun = int((dbg.is_junction_final & reach_jun).sum())
    m = dbg.nodes.shape[0]
    ucap = min(max(1, _next_pow2(max(num_u, 1))), m)
    total_chars = int(dbg.unitig_len[:ucap].sum()) + num_u * (k - 1)
    char_cap = max(8, _next_pow2(total_chars + 1))
    jun_cap = max(1, _next_pow2(max(n_jun, 1)))

    seq_pack = emit_mod.materialize_sequences(dbg, chars, k=k, ucap=ucap,
                                              char_cap=char_cap)
    jun_pack = emit_mod.pack_junctions(dbg, cov, reach_jun, jun_cap=jun_cap)
    seq_np = emit_mod.SeqPack(*[t.cpu().numpy() for t in seq_pack])
    jun_np = emit_mod.JunPack(*[t.cpu().numpy() for t in jun_pack])
    seqs = gfa_mod.sequences_from_pack(seq_np, num_u, k)
    lines = gfa_mod.gfa_lines(jun_np, seq_np,
                              reach_uni[:max(ucap, 1)].cpu().numpy(),
                              num_u, m, k, seqs=seqs)
    return seqs, lines


def assemble(source, config: AssemblyConfig,
             log: Optional[PipelineLog] = None, write_output: bool = True,
             mesh=None, extra_solid=None, device="cuda") -> AssemblyResult:
    """Assemble reads -> GFA on ``device``: the card by default, ``"cpu"``
    to run the kernels' plain PyTorch versions.  With no card, the
    default raises rather than falling back to the CPU.

    ``source``: path to .fasta/.fastq, a list of sequence strings, or a
    prepared ``ReadBatch``.  ``extra_solid``: sequences whose k-mers join
    the node set whatever their coverage, and whose first k-mers join the
    seeds (the multi-k re-seeding hook, ``graph/multik.py``).  ``mesh``
    exists for signature parity with the JAX package and is not ported
    yet.

    ``config.profile_stages`` synchronises the device at stage boundaries
    so ``result.stats['stages']`` is exact; on a CUDA device
    ``result.stats['peak_bytes']`` holds each stage's peak allocation.
    """
    if mesh is not None:
        raise NotImplementedError("mesh / sharding (ROADMAP.md Queue 1 "
                                  "item 4)")
    reason = _unsupported(config)
    if reason:
        raise NotImplementedError(reason)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"assemble on {device}: no CUDA device is "
                           f"available (pass device='cpu' to run on the CPU)")
    log = log or PipelineLog(config.log_path, echo=False)
    t0 = time.time()
    timer = StageTimer(barriers=config.profile_stages, device=device)
    log.write("Assemble")

    # ---- load ----
    if isinstance(source, reads_mod.ReadBatch):
        batch = source
    elif isinstance(source, (list, tuple)):
        batch = reads_mod.reads_from_strings(list(source), config.k,
                                             config.chunk_len)
    else:
        batch = reads_mod.load_reads(source, config.k, config.chunk_len)
    log.write(f"read file loaded ({batch.num_reads} reads, "
              f"{batch.all_bases} bases, {batch.num_chunks} chunks)")
    timer.mark("load")

    if batch.num_reads == 0:
        lines = ["H\tVN:Z:1.0"]
        if write_output:
            with open(config.gfa_path, "w") as f:
                f.write("\n".join(lines) + "\n")
        log.write("finish (no reads >= k)")
        return AssemblyResult(
            gfa_lines=lines, straight_seqs=[], dbg=None, cov=None,
            reach_jun=None, reach_uni=None, num_nodes=0, num_junctions=0,
            num_straights=0,
            stats={"elapsed_s": time.time() - t0, "all_bases": 0,
                   "num_reads": 0, "solid_nodes": 0})

    need_bloom = (not config.use_exact_membership) or config.build_bloom
    if need_bloom:
        bits, hashes = config.auto_filter_bits(batch.all_bases)
        bf = bloom_mod.make_bloom(bits, hashes, device=device)
        log.metric("filter_bits", 1 << bf.log2_bits)
        log.metric("num_hashes", bf.num_hashes)
    else:
        bf = bloom_mod.make_bloom(8, 1, device=device)  # never built/queried

    def dev(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)

    packed = dev(batch.packed)
    valid_len = dev(batch.valid_len)
    read_id = dev(batch.read_id)
    start = dev(batch.start)
    read_len = dev(batch.read_len)

    # ---- stage 1: count + solidity + seeds ----
    table, seed_fw, has_seed, nid = _stage1(
        packed, valid_len, read_id, start, read_len, config.cov_threshold,
        k=config.k, short_k=min(config.short_k, config.k),
        num_reads=batch.num_reads)
    if extra_solid:
        etab, eseed = _extra_solid_table(extra_solid, config, device)
        table = count_mod.merge_tables(table, etab)
        del etab
        nid = None  # node ranks shifted; stage 3 looks the positions up
        seed_fw = torch.cat([seed_fw, eseed], dim=0)
        has_seed = torch.cat([has_seed, torch.ones(
            (eseed.shape[0],), dtype=torch.bool, device=device)])
        log.write(f"extra-solid merge: {len(extra_solid)} seqs")
    num_nodes = int(table.size)
    log.write(f"counted short kmer; solid nodes={num_nodes}")
    log.metric("seed kmer num", int(has_seed.sum()))
    timer.mark("stage1_count_solid")

    # ---- compact node table to the graph capacity ----
    nodes = _pad_table_keys(table.keys, num_nodes, _graph_cap(num_nodes))
    del table
    size = torch.tensor(num_nodes, dtype=torch.int64, device=device)
    if need_bloom:
        bf = _bloom_from_nodes(nodes, size, bf, k=config.k)
        timer.mark("bloom_build")

    # ---- stage 2: graph ----
    dbg = run_stage2(nodes, size, bf, k=config.k,
                     use_exact=config.use_exact_membership)
    closure_rounds = 0
    if not config.use_exact_membership and config.bloom_expand_rounds:
        dbg, nodes, size, closure_rounds = _expand_bloom_closure(
            dbg, nodes, size, bf, config, log)
        if closure_rounds:
            # Node rows shifted; stage 3 looks the positions up again.
            nid = None
    log.write("de bruijn graph loaded")
    timer.mark("stage2_graph")

    # ---- stage 3: coverage + reachability ----
    prev_base, next_base = dev(batch.prev_base), dev(batch.next_base)

    def run_stage3(dbg, nid):
        return _stage3(dbg, packed, valid_len, start, read_len, prev_base,
                       next_base, seed_fw, has_seed, nid, k=config.k)

    stage3 = run_stage3(dbg, nid)
    log.write("count node coverage")
    timer.mark("stage3_coverage")

    simplify_drops = 0
    if config.clip_tips or config.pop_bubbles:
        dbg, stage3, simplify_drops = _simplify(dbg, stage3, nid, bf, config,
                                                log, run_stage3, timer)
        timer.mark("simplify")
    cov, reach_jun, reach_uni, chars = stage3

    if not config.restrict_to_seeds:
        reach_jun = torch.ones_like(reach_jun)
        reach_uni = torch.ones_like(reach_uni)

    # ---- stage 4: device emission packs -> host GFA rendering ----
    seqs, lines = _emit_output(dbg, cov, reach_jun, reach_uni, chars,
                               config.k)
    if write_output:
        with open(config.gfa_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    timer.mark("stage4_emit")
    n_s = sum(1 for ln in lines if ln.startswith("S\tStraight"))
    n_j = sum(1 for ln in lines if ln.startswith("S\tJunction"))
    log.write(f"finish ({time.time() - t0:.2f}s, {n_s} straights, "
              f"{n_j} junctions)")
    stats = {"elapsed_s": time.time() - t0,
             "k": config.k,
             "all_bases": batch.all_bases,
             "num_reads": batch.num_reads,
             "solid_nodes": num_nodes,
             "graph_nodes": int(dbg.size),
             "straights": n_s,
             "junctions": n_j,
             "straight_n50": _n50([len(ln.split("\t")[2]) for ln in lines
                                   if ln.startswith("S\tStraight")]),
             "closure_rounds": closure_rounds,
             "simplify_drops": simplify_drops,
             "device": str(device),
             "stages": dict(timer.spans)}
    if timer.peak_bytes:
        stats["peak_bytes"] = dict(timer.peak_bytes)
    log.write("stats " + json.dumps(stats))
    return AssemblyResult(
        gfa_lines=lines, straight_seqs=seqs, dbg=dbg, cov=cov,
        reach_jun=reach_jun, reach_uni=reach_uni,
        num_nodes=int(dbg.size), num_junctions=n_j, num_straights=n_s,
        stats=stats)
