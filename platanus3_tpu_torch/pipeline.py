"""End-to-end single-shot assembly pipeline.

Port of ``platanus3_tpu/pipeline.py`` (single-shot ``assemble``, at any
k), with the same stage boundaries and capacities, so that every array
compares one to one with the JAX package:

  stage 1 (device): short-k count -> window-min solidity -> solid node
            table, per-position node ids, per-read seed k-mers; with
            ``extra_solid`` (multi-k re-seeding, ``graph/multik.py``) the
            k-mers of those sequences are merged into the table
  compaction: the node table is cut to ``graph_cap(num_nodes)`` rows
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

``config.checkpoint_dir`` checkpoints stages 1, 2 and 3 as the JAX
package does (``utils/checkpoint.py``), and ``config.trace_dir`` wraps the
run in a ``torch.profiler`` trace (``utils/profiling.device_trace``).
Streaming is a separate entry point (``streaming.assemble_streaming``,
``--streaming`` in the CLI).  With a ``mesh`` (``parallel/sharded.py``),
stage 1 runs sharded over the ranks, Bloom build included; stages 2-4
then run on rank 0 alone while the other ranks wait, and every rank
returns rank 0's GFA lines, counts and stats (``share_result``).  The
TPU-only staged paths are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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
from platanus3_tpu_torch.ops import coverage_tally as tally_mod
from platanus3_tpu_torch.ops import kmer as kmer_mod
from platanus3_tpu_torch.ops import slice_kmers as slice_mod
from platanus3_tpu_torch.ops import solid as solid_mod
from platanus3_tpu_torch.parallel import sharded
from platanus3_tpu_torch.utils import checkpoint as ckpt_mod
from platanus3_tpu_torch.utils.logging import PipelineLog
from platanus3_tpu_torch.utils.profiling import (StageTimer, device_trace,
                                                 timed_part)

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


# Version of the checkpointed layouts (int64 lanes and ids, int32 Bloom
# words, DBG leaves by field name) and of the probes that set a filter's
# bits; part of every checkpoint digest.  2: filters of
# ``bloom.WIDE_LOG2_BITS`` bits and more probe through the 64-bit wide
# hash, so the words a format-1 checkpoint holds answer no query now.
CHECKPOINT_FORMAT = "torch-fmt=2"


def check_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} on {device}: no CUDA device is "
                           f"available (pass device='cpu' to run on the CPU)")
    return device


def load_batch(source, config: AssemblyConfig) -> reads_mod.ReadBatch:
    """A ``ReadBatch`` from a path (the native loader), a list of
    sequences, or a prepared batch."""
    if isinstance(source, reads_mod.ReadBatch):
        return source
    if isinstance(source, (list, tuple)):
        return reads_mod.reads_from_strings(list(source), config.k,
                                            config.chunk_len)
    return reads_mod.load_reads(source, config.k, config.chunk_len)


def checkpointer(config: AssemblyConfig, batch, need_bloom: bool,
                 extra_solid, *tokens) -> Optional[ckpt_mod.Checkpointer]:
    """The run's checkpointer (None without ``checkpoint_dir``), keyed by
    the format, ``tokens``, every knob a checkpointed stage depends on
    and digests of the reads and the extra-solid sequences."""
    if not config.checkpoint_dir:
        return None
    return ckpt_mod.Checkpointer(
        config.checkpoint_dir,
        digest_parts=(CHECKPOINT_FORMAT, *tokens,
                      config.k, config.short_k, config.cov_threshold,
                      config.filter_policy, config.filter_bits,
                      config.num_hashes, config.chunk_len, need_bloom,
                      batch.num_reads, batch.all_bases,
                      config.use_exact_membership, config.clip_tips,
                      config.pop_bubbles, config.simplify_rounds,
                      config.tip_max_len, config.tip_cov_ratio,
                      config.bubble_len_ratio, config.bloom_expand_rounds,
                      ckpt_mod.digest_of(batch.packed),
                      ckpt_mod.digest_of(np.frombuffer(
                          "\n".join(extra_solid).encode(), np.uint8))
                      if extra_solid else ""))


def save_stage3(ckpt, dbg, cov, reach_jun, reach_uni, chars) -> None:
    """The post-simplification graph, coverage, reachability and member
    chars: a resume goes straight to emission."""
    ckpt.save("stage3", **ckpt_mod.tuple_arrays("dbg", dbg),
              **ckpt_mod.tuple_arrays("cov", cov), reach_jun=reach_jun,
              reach_uni=reach_uni, chars=chars)


def load_stage3(ckpt, device):
    d = ckpt.load("stage3", device)
    return (ckpt_mod.tuple_from(build_mod.DBG, "dbg", d),
            ckpt_mod.tuple_from(cov_mod.CoverageResult, "cov", d),
            d["reach_jun"], d["reach_uni"], d["chars"])


def _stage1(packed, valid_len, read_id, start, read_len, cov_threshold, *,
            k, short_k, num_reads, timer=None):
    """Stage 1, in the parts ``stage1.solid``, ``stage1.seeds`` and
    ``stage1.node_ids`` of ``timer``'s span."""
    timer = timer or StageTimer()
    with timer.part("stage1.solid"):
        result = solid_mod.solid_kmers(
            (packed, valid_len, read_id, start, read_len), k, short_k,
            cov_threshold, need_short_table=False)
    with timer.part("stage1.seeds"):
        seed_fw, has_seed = solid_mod.first_solid_per_read(
            result, read_id, start, num_reads)
    with timer.part("stage1.node_ids"):
        c, pk, l = result.canon.shape
        # One sort yields the node table AND every position's node id;
        # the node table's counts are never read (coverage is stage 3's).
        node_table, nid = count_mod.count_solid_with_ids(
            result.canon.reshape(-1, l), result.owned.reshape(-1),
            (result.is_solid & result.owned).reshape(-1), k=k,
            want_counts=False)
    return node_table, seed_fw, has_seed, nid.reshape(c, pk)


def extra_solid_table(seqs, config, device):
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


def run_stage2(nodes, size, bf, *, k, use_exact, timer=None):
    return build_mod.build_graph(nodes, size, k, bf, use_exact=use_exact,
                                 timer=timer)


def note_bloom(timer, dbg, bf) -> None:
    """The Bloom filter's counters, under ``--profile-stages`` only
    (``StageTimer.note``): ``bloom_false_neighbours``, the Bloom-positive
    neighbours of the graph stage 2 first builds from the solid nodes
    that are no node (``build.false_neighbours``), and ``bloom_bits_set``,
    the complete filter's set bits.  An ideal filter of ``m`` bits and
    ``h`` probes holding ``n`` nodes reads 0 and about ``m * (1 - exp(-h
    * n / m))``.  The false neighbours are summed on the device here, the
    set bits at the end of the run; the host reads both then."""
    if timer.profile:
        false = build_mod.false_neighbours(dbg)
        timer.note("bloom_false_neighbours", lambda: false)
        timer.note("bloom_bits_set", lambda: bloom_mod.popcount(bf))


def _stage3(dbg, packed, valid_len, start, read_len, prev_base, next_base,
            seed_fw, has_seed, nid, *, k, timer=None):
    """Stage 3; its coverage and junction tallies are the part
    ``coverage.tally`` of ``timer``'s span."""
    with timed_part(timer, "coverage.tally"):
        tally = cov_mod.CoverageTally(dbg, k)
        tally.add(packed, valid_len, start, read_len, prev_base, next_base,
                  nid=nid)
        cov = tally.result()
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


def graph_cap(n: int) -> int:
    """Node capacity for the graph stage: a power of two up to 2^22
    nodes, above that the next multiple of 2^20 (as the JAX package)."""
    p = max(8, _next_pow2(n))
    if p <= _GRAPH_CAP_POW2_MAX:
        return p
    return min(p, -(-int(n) // _GRAPH_CAP_STEP) * _GRAPH_CAP_STEP)


def pad_table_keys(keys, size: int, cap: int):
    rows, lanes = keys.shape
    if cap <= rows:
        return keys[:cap]
    pad = torch.full((cap - rows, lanes), _PAD, dtype=keys.dtype,
                     device=keys.device)
    return torch.cat([keys, pad], dim=0)


def _expand_bloom_closure(dbg, nodes, size, bf, config, log, timer):
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
        nodes = pad_table_keys(merged.keys, n_new, graph_cap(n_new))
        size = torch.tensor(n_new, dtype=torch.int64, device=nodes.device)
        del merged, dbg
        dbg = run_stage2(nodes, size, bf, k=config.k, use_exact=False,
                         timer=timer)
        log.write(f"bloom closure round {rnd + 1}: {n_extra} phantom "
                  f"neighbor k-mers -> {n_new} nodes")
    return dbg, nodes, size, grown


# The DBG leaves the simplification decision reads on the host.
_SIMPLIFY_LEAVES = ("size", "left_present", "right_present",
                    "node_state_uid", "state_next_id", "state_next_o",
                    "unitig_head", "unitig_tail", "unitig_len",
                    "unitig_circular", "num_unitigs")


def simplify_graph(dbg, stage3, nid, bf, config, log, run_stage3, timer):
    """Tip clipping / bubble popping rounds after stage 3 (``stage3`` is
    its outputs): the drop decision on the host
    (``graph/simplify.decide_drops``), then the graph rebuilt from the
    kept nodes with EXACT membership (after a deletion the Bloom filter no
    longer describes the node set) and stage 3 run again.  Kept nodes keep
    their lexicographic order, so stage 1's node ids remap by rank among
    the kept rows.  Each round's parts are parts of ``timer``'s span:
    ``simplify.to_host`` (the DBG leaves and coverage to numpy),
    ``simplify.decide``, ``simplify.stage2`` (the kept keys and the
    rebuild) and ``simplify.stage3``.  Returns ``(dbg, stage-3 outputs,
    unitigs dropped)``."""
    rounds = config.simplify_rounds if config.simplify_rounds > 0 else 100
    dropped = 0
    for rnd in range(rounds):
        with timer.part("simplify.to_host"):
            dbg_np = dbg._replace(**{f: getattr(dbg, f).cpu().numpy()
                                     for f in _SIMPLIFY_LEAVES})
            node_cov = stage3[0].node_cov.cpu().numpy()
        with timer.part("simplify.decide"):
            keep, n_drop = simp_mod.decide_drops(dbg_np, node_cov, config)
        if keep is None:
            break
        dropped += n_drop
        with timer.part("simplify.stage2"):
            keep = torch.from_numpy(keep).to(dbg.nodes.device)
            kept = dbg.nodes[keep]
            n_keep = kept.shape[0]
            nodes = pad_table_keys(kept, n_keep, graph_cap(n_keep))
            size = torch.tensor(n_keep, dtype=torch.int64,
                                device=nodes.device)
            del dbg, kept, stage3
            dbg = run_stage2(nodes, size, bf, k=config.k, use_exact=True)
        with timer.part("simplify.stage3"):
            if nid is not None:
                remap = torch.where(keep, torch.cumsum(keep, 0) - 1, -1)
                nid = torch.where(nid >= 0, remap[nid.clamp(min=0)], -1)
            stage3 = run_stage3(dbg, nid)
        log.write(f"simplify round {rnd + 1}: dropped {n_drop} unitigs, "
                  f"{n_keep} nodes left")
    return dbg, stage3, dropped


def _emit_output(dbg, cov, reach_jun, reach_uni, chars, k, timer):
    """Stage 4: compact emission packs on the device (part ``emit.pack``,
    with the sizes read before them), their copies to the host
    (``emit.to_host``), the GFA text on the host (``emit.text``)."""
    with timer.part("emit.pack"):
        num_u = int(dbg.num_unitigs)
        n_jun = int((dbg.is_junction_final & reach_jun).sum())
        m = dbg.nodes.shape[0]
        ucap = min(max(1, _next_pow2(max(num_u, 1))), m)
        total_chars = int(dbg.unitig_len[:ucap].sum()) + num_u * (k - 1)
        char_cap = max(8, _next_pow2(total_chars + 1))
        jun_cap = max(1, _next_pow2(max(n_jun, 1)))
        seq_pack = emit_mod.materialize_sequences(dbg, chars, k=k, ucap=ucap,
                                                  char_cap=char_cap)
        jun_pack = emit_mod.pack_junctions(dbg, cov, reach_jun,
                                           jun_cap=jun_cap)
    with timer.part("emit.to_host"):
        seq_np = emit_mod.SeqPack(*[t.cpu().numpy() for t in seq_pack])
        jun_np = emit_mod.JunPack(*[t.cpu().numpy() for t in jun_pack])
        uni_np = reach_uni[:max(ucap, 1)].cpu().numpy()
    with timer.part("emit.text"):
        seqs = gfa_mod.sequences_from_pack(seq_np, num_u, k)
        lines = gfa_mod.gfa_lines(jun_np, seq_np, uni_np, num_u, m, k,
                                  seqs=seqs)
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
    seeds (the multi-k re-seeding hook, ``graph/multik.py``).  ``mesh``:
    this rank's ``parallel.sharded.Mesh``; every rank calls with the same
    arguments, stage 1 runs sharded on the mesh devices, and every rank
    returns rank 0's result without the graph.

    ``config.checkpoint_dir`` saves stages 1, 2 and 3 and resumes from
    the last one found; ``config.trace_dir`` writes a ``torch.profiler``
    trace of the run there.  ``result.stats['stages']`` holds the spans
    of ``utils/profiling.StageTimer`` (seconds), ``stats['counts']`` each
    counter's rise over the run and ``stats['span_counts']`` its rise over
    each span.  ``config.profile_stages`` synchronises the device at span
    boundaries so the spans are exact; on a CUDA device it also puts each
    stage's peak allocation in ``stats['peak_bytes']`` and counts the
    host's waits for the device (counter ``host_syncs``); in Bloom
    membership it adds the counters of ``note_bloom`` and the part
    ``graph.bloom_query`` of stage 2.
    """
    if mesh is not None:
        device = mesh.device
    device = check_device(device, "assemble")
    with device_trace(trace_dir(config, mesh), device):
        return _assemble_impl(source, config, log, write_output,
                              extra_solid, device, mesh)


def trace_dir(config, mesh):
    """Where the run's trace goes: only rank 0 of a mesh traces."""
    return config.trace_dir if mesh is None or mesh.is_root else ""


def mesh_flags(mesh, *flags):
    """Rank 0's decisions (checkpoint restores) on every rank."""
    if mesh is None:
        return flags
    return sharded.broadcast_object(mesh, flags)


# Process-wide counts whose rise over each span and over the run the stats
# line gives (and each rank reports on a mesh).
RUN_COUNTERS = {"bloom_set_bits_launches":
                lambda: bloom_mod.bloom_add.kernel_launches,
                "slice_kmers_launches":
                lambda: slice_mod.slice_kmers.kernel_launches,
                "coverage_tally_launches":
                lambda: tally_mod.coverage_tally.kernel_launches}


def run_timer(config, device, mesh) -> StageTimer:
    """The run's ``StageTimer`` (with ``RUN_COUNTERS``), to be entered
    around the run; on a mesh, this rank's byte counts start again from
    0."""
    if mesh is not None:
        mesh.traffic.clear()
    return StageTimer(profile=config.profile_stages, device=device,
                      counters=RUN_COUNTERS)


def root_part(mesh, stack: contextlib.ExitStack) -> None:
    """From here on rank 0 works alone while the other ranks wait for it
    (``sharded.root_section``): an error on rank 0 reaches them."""
    if mesh is not None and mesh.is_root:
        stack.enter_context(sharded.root_section(mesh))


def share_result(mesh, timer, result: Optional[AssemblyResult] = None
                 ) -> AssemblyResult:
    """The end of a mesh run on a rank other than 0: hand this rank's
    stats to rank 0 (``mesh_stats``), then return rank 0's result without
    the graph.  Rank 0 calls it with its result, after ``finish``."""
    if not mesh.is_root:
        timer.end()
        mesh_stats(mesh, timer)
    shared = sharded.broadcast_object(mesh, None if result is None else (
        result.gfa_lines, result.straight_seqs, result.num_nodes,
        result.num_junctions, result.num_straights, result.stats))
    if mesh.is_root:
        return result
    lines, seqs, n_nodes, n_j, n_s, stats = shared
    return AssemblyResult(gfa_lines=lines, straight_seqs=seqs, dbg=None,
                          cov=None, reach_jun=None, reach_uni=None,
                          num_nodes=n_nodes, num_junctions=n_j,
                          num_straights=n_s, stats=stats)


def mesh_stats(mesh, timer) -> dict:
    """``stats['mesh']``: the backend, the devices and every rank's
    ``sharded.rank_stats`` with its ``RUN_COUNTERS``.  The other ranks
    wait in a broadcast until rank 0 gets here, so that an error of
    rank 0 before it reaches them (``root_part``)."""
    sharded.broadcast_object(mesh, "stats")
    return {"backend": mesh.backend, "world_size": mesh.size,
            "devices": mesh.devices,
            "ranks": sharded.rank_stats(mesh, timer, timer.counts())}


def _assemble_impl(source, config, log, write_output, extra_solid, device,
                   mesh):
    with run_timer(config, device, mesh) as timer, \
            contextlib.ExitStack() as rank0_alone:
        return _assemble_body(source, config, log, write_output, extra_solid,
                              device, mesh, timer, rank0_alone)


def _assemble_body(source, config, log, write_output, extra_solid, device,
                   mesh, timer, rank0_alone):
    log = log or PipelineLog(config.log_path, echo=False)
    timer.begin("load")
    if mesh is not None:
        log.write(sharded.describe(mesh))
    log.write("Assemble")

    # ---- load ----
    batch = load_batch(source, config)
    log.write(f"read file loaded ({batch.num_reads} reads, "
              f"{batch.all_bases} bases, {batch.num_chunks} chunks)")
    timer.begin("stage1_count_solid")

    if batch.num_reads == 0:
        return empty_result(config, log, timer, write_output and (
            mesh is None or mesh.is_root))

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

    def upload():
        return tuple(dev(getattr(batch, f)) for f in (
            "packed", "valid_len", "read_id", "start", "read_len"))

    # On a mesh, rank 0 uploads the whole batch only after sharded stage 1.
    arrays = upload() if mesh is None else None

    # ---- stage 1: count + solidity + seeds ----
    ckpt = (checkpointer(config, batch, need_bloom, extra_solid)
            if mesh is None or mesh.is_root else None)
    restored1, = mesh_flags(mesh, ckpt is not None and ckpt.has("stage1"))
    bloom_pending = need_bloom  # the sharded stage 1 builds it instead
    if restored1:
        if mesh is not None and not mesh.is_root:
            return share_result(mesh, timer)
        root_part(mesh, rank0_alone)
        # The saved table and seeds include the extra-solid merge.
        d = ckpt.load("stage1", device)
        table = ckpt_mod.tuple_from(count_mod.KmerTable, "table", d)
        seed_fw, has_seed, nid = d["seed_fw"], d["has_seed"], None
        log.write("stage1 restored from checkpoint")
    elif mesh is not None:
        table, bf, seed_fw, has_seed = _sharded_stage1(
            mesh, batch, bf, config, need_bloom)
        nid, bloom_pending = None, False
        if not mesh.is_root:
            return share_result(mesh, timer)
        root_part(mesh, rank0_alone)
    else:
        table, seed_fw, has_seed, nid = _stage1(
            *arrays, config.cov_threshold, k=config.k,
            short_k=min(config.short_k, config.k),
            num_reads=batch.num_reads, timer=timer)
    packed, valid_len, read_id, start, read_len = arrays or upload()
    if extra_solid and not restored1:
        etab, eseed = extra_solid_table(extra_solid, config, device)
        table = count_mod.merge_tables(table, etab)
        del etab
        nid = None  # node ranks shifted; stage 3 looks the positions up
        seed_fw = torch.cat([seed_fw, eseed], dim=0)
        has_seed = torch.cat([has_seed, torch.ones(
            (eseed.shape[0],), dtype=torch.bool, device=device)])
        log.write(f"extra-solid merge: {len(extra_solid)} seqs")
    num_nodes = int(table.size)
    if ckpt is not None and not restored1:
        # Only the valid prefix: the compaction below pads again.
        n_keep = max(num_nodes, 1)
        ckpt.save("stage1", **ckpt_mod.tuple_arrays("table", table._replace(
            keys=table.keys[:n_keep], counts=table.counts[:n_keep])),
            seed_fw=seed_fw, has_seed=has_seed)
        log.write("stage1 checkpoint saved")
    log.write(f"counted short kmer; solid nodes={num_nodes}")
    log.metric("seed kmer num", int(has_seed.sum()))
    timer.begin("bloom_build" if bloom_pending else "stage2_graph")

    # ---- compact node table to the graph capacity ----
    nodes = pad_table_keys(table.keys, num_nodes, graph_cap(num_nodes))
    del table
    size = torch.tensor(num_nodes, dtype=torch.int64, device=device)
    if bloom_pending:
        bf = _bloom_from_nodes(nodes, size, bf, k=config.k)
        timer.begin("stage2_graph")

    # ---- stage 2: graph ----
    restored3 = ckpt is not None and ckpt.has("stage3")
    closure_rounds = 0
    if restored3:
        dbg = None  # the stage-3 checkpoint holds the final graph
    elif ckpt is not None and ckpt.has("stage2"):
        dbg = ckpt_mod.tuple_from(build_mod.DBG, "dbg",
                                  ckpt.load("stage2", device))
        log.write("stage2 restored from checkpoint")
    else:
        dbg = run_stage2(nodes, size, bf, k=config.k,
                         use_exact=config.use_exact_membership, timer=timer)
        if not config.use_exact_membership:
            note_bloom(timer, dbg, bf)
        if not config.use_exact_membership and config.bloom_expand_rounds:
            dbg, nodes, size, closure_rounds = _expand_bloom_closure(
                dbg, nodes, size, bf, config, log, timer)
            if closure_rounds:
                # Node rows shifted; stage 3 looks the positions up again.
                nid = None
        if ckpt is not None:
            ckpt.save("stage2", **ckpt_mod.tuple_arrays("dbg", dbg))
            log.write("stage2 checkpoint saved")
    log.write("de bruijn graph loaded")
    timer.begin("stage3_coverage")

    # ---- stage 3: coverage + reachability ----
    prev_base, next_base = dev(batch.prev_base), dev(batch.next_base)

    def run_stage3(dbg, nid):
        return _stage3(dbg, packed, valid_len, start, read_len, prev_base,
                       next_base, seed_fw, has_seed, nid, k=config.k,
                       timer=timer)

    if restored3:
        dbg, *stage3 = load_stage3(ckpt, device)
        log.write("stage3 restored from checkpoint (skip to emission)")
    else:
        stage3 = run_stage3(dbg, nid)
        log.write("count node coverage")

    simplify_drops = 0
    if (config.clip_tips or config.pop_bubbles) and not restored3:
        timer.begin("simplify")
        dbg, stage3, simplify_drops = simplify_graph(
            dbg, stage3, nid, bf, config, log, run_stage3, timer)
    timer.begin("stage4_emit")
    cov, reach_jun, reach_uni, chars = stage3
    if ckpt is not None and not restored3:
        save_stage3(ckpt, dbg, cov, reach_jun, reach_uni, chars)
        log.write("stage3 checkpoint saved")

    result = finish(config, log, timer, batch, write_output, dbg, cov,
                    reach_jun, reach_uni, chars, device, solid_nodes=num_nodes,
                    closure_rounds=closure_rounds,
                    simplify_drops=simplify_drops, mesh=mesh)
    return result if mesh is None else share_result(mesh, timer, result)


def _sharded_stage1(mesh, batch, bf, config, need_bloom):
    """Stage 1 over the mesh (``sharded.sharded_stage1``) on the padded
    batch; raises JAX's message on every rank when a bucket overflowed.
    Returns ``(table, bf, seed_fw, has_seed)``."""
    arrays = sharded.pad_batch_to_devices(
        (batch.packed, batch.valid_len, batch.read_id, batch.start,
         batch.read_len), mesh.size)
    table, bf, seed_fw, has_seed, ovf = sharded.sharded_stage1(
        mesh, *arrays, bf, k=config.k,
        short_k=min(config.short_k, config.k),
        cov_threshold=config.cov_threshold, num_reads=batch.num_reads,
        add_to_bloom=need_bloom)
    if ovf > 0:
        raise RuntimeError(f"all-to-all bucket overflow ({ovf} k-mers "
                           f"dropped); increase slack")
    sharded.release_cache(mesh)
    return table, bf, seed_fw, has_seed


def empty_result(config, log, timer, write_output) -> AssemblyResult:
    """The header-only GFA of a read set without a read of k bases or
    more (the reference drops shorter reads, ``src/Load.cpp:59,86``)."""
    lines = ["H\tVN:Z:1.0"]
    if write_output:
        with open(config.gfa_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    log.write("finish (no reads >= k)")
    return AssemblyResult(
        gfa_lines=lines, straight_seqs=[], dbg=None, cov=None,
        reach_jun=None, reach_uni=None, num_nodes=0, num_junctions=0,
        num_straights=0,
        stats={"elapsed_s": timer.elapsed(), "all_bases": 0,
               "num_reads": 0, "solid_nodes": 0})


def finish(config, log, timer, batch, write_output, dbg, cov, reach_jun,
           reach_uni, chars, device, *, solid_nodes, closure_rounds,
           simplify_drops, mesh=None) -> AssemblyResult:
    """Stage 4 and the result, shared with the streaming pipeline: the
    seed-restriction override, the emission packs, the GFA (inside the
    stage-4 span the caller began), then span ``finish``: the counts, the
    N50 and the ``stats`` log line (on a mesh, rank 0's, with
    ``stats['mesh']`` gathered from every rank just before)."""
    if not config.restrict_to_seeds:
        reach_jun = torch.ones_like(reach_jun)
        reach_uni = torch.ones_like(reach_uni)

    # ---- stage 4: device emission packs -> host GFA rendering ----
    seqs, lines = _emit_output(dbg, cov, reach_jun, reach_uni, chars,
                               config.k, timer)
    with timer.part("emit.write"):
        if write_output:
            with open(config.gfa_path, "w") as f:
                f.write("\n".join(lines) + "\n")
    timer.begin("finish")
    straight_lens = [len(ln.split("\t")[2]) for ln in lines
                     if ln.startswith("S\tStraight")]
    n_s = len(straight_lens)
    n_j = sum(1 for ln in lines if ln.startswith("S\tJunction"))
    num_nodes = int(dbg.size)
    log.write(f"finish ({timer.elapsed():.2f}s, {n_s} straights, {n_j} "
              f"junctions)")
    stats = {"k": config.k,
             "all_bases": batch.all_bases,
             "num_reads": batch.num_reads,
             "solid_nodes": solid_nodes,
             "graph_nodes": num_nodes,
             "straights": n_s,
             "junctions": n_j,
             "straight_n50": _n50(straight_lens),
             "closure_rounds": closure_rounds,
             "simplify_drops": simplify_drops,
             "device": str(device)}
    if mesh is not None:
        stats["mesh"] = mesh_stats(mesh, timer)
    timer.end()
    stats.update(elapsed_s=timer.elapsed(), stages=dict(timer.spans),
                 counts=timer.counts(), span_counts=timer.span_counts)
    if timer.peak_bytes:
        stats["peak_bytes"] = dict(timer.peak_bytes)
    log.write("stats " + json.dumps(stats))
    return AssemblyResult(
        gfa_lines=lines, straight_seqs=seqs, dbg=dbg, cov=cov,
        reach_jun=reach_jun, reach_uni=reach_uni,
        num_nodes=num_nodes, num_junctions=n_j, num_straights=n_s,
        stats=stats)
