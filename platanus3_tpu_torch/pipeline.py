"""End-to-end assembly: single shot, and the job driver both modes share.

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
  stage 3 (device): coverage and junction tallies; simplification
            (``clip_tips`` / ``pop_bubbles``) chooses tips and bubbles on
            the host (``graph/simplify.py``), rebuilds the graph without
            them with exact membership and covers again, for
            ``simplify_rounds`` rounds or to the fixpoint; then seed
            reachability and member chars
  stage 4 (device -> host): emission packs, GFA rendering

``run_job`` runs this sequence for single shot and for streaming
(``streaming.assemble_streaming``, ``--streaming`` in the CLI); a ``Mode``
brings its span names, its checkpoint stages and two functions: the front
end (stage 1, or streaming's passes 1-2) and the coverage.  With a
``mesh`` (``parallel/sharded.py``) the front end runs sharded over the
ranks, then rank 0 goes on alone while the other ranks take part only in
streaming's coverage passes, and every rank returns rank 0's GFA lines,
counts and stats.  ``config.checkpoint_dir`` checkpoints the front end,
stage 2 (single shot) and stage 3 (``utils/checkpoint.py``), and
``config.trace_dir`` wraps the run in a ``torch.profiler`` trace.  The
TPU-only staged paths are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
from typing import Callable, NamedTuple, Optional

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


def load_batch(source, config: AssemblyConfig,
               timer=None) -> reads_mod.ReadBatch:
    """A ``ReadBatch`` from a path (the native loader, its parts timed
    by ``timer`` where one is given), a list of sequences, or a prepared
    batch."""
    if isinstance(source, reads_mod.ReadBatch):
        return source
    if isinstance(source, (list, tuple)):
        return reads_mod.reads_from_strings(list(source), config.k,
                                            config.chunk_len)
    return reads_mod.load_reads(source, config.k, config.chunk_len,
                                timer=timer)


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


def _tally(dbg, packed, valid_len, start, read_len, prev_base, next_base,
           nid, *, k, timer=None):
    """Coverage and junction tallies of the whole batch, the part
    ``coverage.tally`` of ``timer``'s span."""
    with timed_part(timer, "coverage.tally"):
        tally = cov_mod.CoverageTally(dbg, k)
        tally.add(packed, valid_len, start, read_len, prev_base, next_base,
                  nid=nid)
        return tally.result()


def reach_chars(dbg, seed_fw, has_seed, k):
    """``(reach_jun, reach_uni, chars)`` of the final graph: the seeds'
    reachability and the member chars, once a run."""
    return (*reach_mod.reachable(dbg, seed_fw, has_seed, k),
            seq_mod.member_chars(dbg, k))


def _stage3(dbg, packed, valid_len, start, read_len, prev_base, next_base,
            seed_fw, has_seed, nid, *, k, timer=None):
    """Stage 3 in one call, as the JAX package's ``_stage3``: the tallies,
    then ``reach_chars``."""
    cov = _tally(dbg, packed, valid_len, start, read_len, prev_base,
                 next_base, nid, k=k, timer=timer)
    return (cov, *reach_chars(dbg, seed_fw, has_seed, k))


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


def simplify_graph(job, dbg, cov, nid, bf, cover):
    """Tip clipping / bubble popping rounds after coverage: the drop
    decision on the host (``graph/simplify.decide_drops``), then the graph
    rebuilt from the kept nodes with EXACT membership (after a deletion
    the Bloom filter no longer describes the node set) and ``cover(dbg,
    nid)`` run again.  Kept nodes keep their lexicographic order, so stage
    1's node ids remap by rank among the kept rows.  Each round's parts
    are parts of the run's span: ``simplify.to_host`` (the DBG leaves
    and coverage to numpy), ``simplify.decide``, ``simplify.stage2`` (the
    kept keys and the rebuild) and ``simplify.stage3`` (coverage).
    Returns ``(dbg, cov, unitigs dropped)``."""
    config, log, timer = job.config, job.log, job.timer
    rounds = config.simplify_rounds if config.simplify_rounds > 0 else 100
    dropped = 0
    for rnd in range(rounds):
        with timer.part("simplify.to_host"):
            dbg_np = dbg._replace(**{f: getattr(dbg, f).cpu().numpy()
                                     for f in _SIMPLIFY_LEAVES})
            node_cov = cov.node_cov.cpu().numpy()
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
            del dbg, kept, cov
            dbg = run_stage2(nodes, size, bf, k=config.k, use_exact=True)
        with timer.part("simplify.stage3"):
            if nid is not None:
                remap = torch.where(keep, torch.cumsum(keep, 0) - 1, -1)
                nid = torch.where(nid >= 0, remap[nid.clamp(min=0)], -1)
            cov = cover(dbg, nid)
        log.write(f"simplify round {rnd + 1}: dropped {n_drop} unitigs, "
                  f"{n_keep} nodes left")
    return dbg, cov, dropped


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


class Spans(NamedTuple):
    """The spans ``run_job`` opens (None: none, the work stays in the span
    in progress).  ``bloom`` holds a Bloom build the front end left
    pending; on a mesh the other ranks follow rank 0's coverage passes in
    ``follow`` (None: rank 0 covers alone).  A restore of the front end's
    checkpoint opens ``restore_front``, one of stage 3's ``restore`` and
    goes straight to emission (without it, stage 3 is restored after the
    front end, in ``coverage``)."""

    front: str
    graph: str
    coverage: str
    emit: str
    bloom: Optional[str] = None
    simplify: Optional[str] = None
    reach: Optional[str] = None
    follow: Optional[str] = None
    restore_front: Optional[str] = None
    restore: Optional[str] = None


class Mode(NamedTuple):
    """A mode of assembly for ``run_job``: ``name`` (the entry point, in
    errors), checkpoint digest ``tokens``, ``spans``, the ``checkpoints``
    saved before stage 3 (the front end's first), whether the Bloom
    ``closure`` runs, and two functions.  ``front(job, bf)``, run by every
    rank of a mesh with the empty filter ``bf`` (an 8-bit stand-in
    without Bloom membership), returns ``(table, seed_fw, has_seed, nid,
    bf, min_pos)``: the node table (rank 0's), the seeds, stage 1's
    per-position node ids or None, the filter holding the solid nodes or
    None (the driver builds it), and each read's first solid position or
    None (``spass2`` keeps it).  ``cover(job, dbg, nid)`` returns the
    coverage of ``dbg``; on a mesh rank 0 calls it with each graph, then
    with None once no pass follows, and the other ranks call it once with
    None, taking part in rank 0's passes until then."""

    name: str
    tokens: tuple
    spans: Spans
    checkpoints: tuple
    closure: bool
    front: Callable
    cover: Callable


@dataclasses.dataclass
class Job:
    """One run as a mode's functions see it; ``on_device`` holds the batch
    fields uploaded so far (``batch_fields``)."""

    config: AssemblyConfig
    batch: reads_mod.ReadBatch
    device: torch.device
    mesh: Optional[sharded.Mesh]
    timer: StageTimer
    log: PipelineLog
    need_bloom: bool
    on_device: dict = dataclasses.field(default_factory=dict)


def batch_fields(job, *names):
    """The batch's fields ``names`` on the device, each uploaded once."""
    for f in names:
        if f not in job.on_device:
            job.on_device[f] = torch.from_numpy(np.asarray(getattr(
                job.batch, f)).astype(np.int64)).to(job.device)
    return tuple(job.on_device[f] for f in names)


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
    spans = Spans(front="stage1_count_solid", bloom="bloom_build",
                  graph="stage2_graph", coverage="stage3_coverage",
                  emit="stage4_emit", simplify="simplify" if (
                      config.clip_tips or config.pop_bubbles) else None)
    return run_job(source, config, log, write_output, extra_solid, device,
                   mesh, Mode("assemble", (), spans, ("stage1", "stage2"),
                              True, _front_batch, _cover_batch))


def _front_batch(job, bf):
    """Single shot's front end: stage 1 over the whole batch on the
    device, the Bloom build left to the driver, or over the mesh
    (``sharded.sharded_stage1`` on the padded batch), Bloom build
    included; raises JAX's message on every rank when a bucket of the
    mesh overflowed."""
    config, batch, mesh = job.config, job.batch, job.mesh
    short_k = min(config.short_k, config.k)
    nid = None
    if mesh is not None:
        arrays = sharded.pad_batch_to_devices(
            (batch.packed, batch.valid_len, batch.read_id, batch.start,
             batch.read_len), mesh.size)
        table, bf, seed_fw, has_seed, ovf = sharded.sharded_stage1(
            mesh, *arrays, bf, k=config.k, short_k=short_k,
            cov_threshold=config.cov_threshold, num_reads=batch.num_reads,
            add_to_bloom=job.need_bloom)
        if ovf > 0:
            raise RuntimeError(f"all-to-all bucket overflow ({ovf} k-mers "
                               f"dropped); increase slack")
        sharded.release_cache(mesh)
    else:
        table, seed_fw, has_seed, nid = _stage1(
            *batch_fields(job, "packed", "valid_len", "read_id", "start",
                          "read_len"), config.cov_threshold, k=config.k,
            short_k=short_k, num_reads=batch.num_reads, timer=job.timer)
        bf = None
    job.log.metric("seed kmer num", int(has_seed.sum()))
    return table, seed_fw, has_seed, nid, bf, None


def _cover_batch(job, dbg, nid):
    """Single shot's coverage: one ``CoverageTally`` over the whole batch,
    with stage 1's ids where they hold.  Rank 0 of a mesh covers alone,
    so a call with None has nothing to do."""
    if dbg is None:
        return None
    return _tally(dbg, *batch_fields(
        job, "packed", "valid_len", "start", "read_len", "prev_base",
        "next_base"), nid, k=job.config.k, timer=job.timer)


# Process-wide counts whose rise over each span and over the run the stats
# line gives (and each rank reports on a mesh).
RUN_COUNTERS = {"bloom_set_bits_launches":
                lambda: bloom_mod.bloom_add.kernel_launches,
                "slice_kmers_launches":
                lambda: slice_mod.slice_kmers.kernel_launches,
                "coverage_tally_launches":
                lambda: tally_mod.coverage_tally.kernel_launches}


def run_job(source, config, log, write_output, extra_solid, device, mesh,
            mode: Mode) -> AssemblyResult:
    """The job of both entry points: load, Bloom set-up, checkpoint key
    and restore flags, ``mode.front``, extra-solid merge, the front end's
    checkpoint, compaction to ``graph_cap``, the Bloom build the front end
    left pending, stage 2 and ``note_bloom``, the Bloom closure where the
    mode runs it, ``mode.cover``, simplification (each round covers
    again), ``reach_chars``, the stage-3 checkpoint and ``finish``.  On a
    mesh, the other ranks run the front end, follow rank 0's coverage
    passes and return rank 0's result (``share_result``); rank 0 works
    alone after the front end, in ``sharded.root_section``, so that its
    errors reach them."""
    log = log or PipelineLog(config.log_path, echo=False)
    if mesh is not None:
        device = mesh.device
        mesh.traffic.clear()     # this rank's bytes count from here
        log.write(sharded.describe(mesh))
    device = check_device(device, mode.name)
    root = mesh is None or mesh.is_root
    spans, front_stage = mode.spans, mode.checkpoints[0]
    with device_trace(config.trace_dir if root else "", device), \
            StageTimer(profile=config.profile_stages, device=device,
                       counters=RUN_COUNTERS) as timer, \
            contextlib.ExitStack() as rank0_alone:
        timer.begin("load")
        log.write("Assemble")
        batch = load_batch(source, config, timer)
        log.write(f"read file loaded ({batch.num_reads} reads, "
                  f"{batch.all_bases} bases, {batch.num_chunks} chunks)")
        if batch.num_reads == 0:
            return empty_result(config, log, timer, write_output and root)

        need_bloom = (not config.use_exact_membership) or config.build_bloom
        ckpt = (checkpointer(config, batch, need_bloom, extra_solid,
                             *mode.tokens) if root else None)
        flags = tuple(ckpt is not None and ckpt.has(stage)
                      for stage in ("stage3", front_stage))
        if mesh is not None:
            flags = sharded.broadcast_object(mesh, flags)   # rank 0's
        restored3, restored = flags
        jump = restored3 and spans.restore is not None
        skip_front = restored or jump
        first = spans.front
        if skip_front:
            first = ((spans.restore if jump else spans.restore_front)
                     if root else spans.follow) or first
        timer.begin(first)
        if need_bloom:
            bits, hashes = config.auto_filter_bits(batch.all_bases)
            bf = bloom_mod.make_bloom(bits, hashes, device=device)
            log.metric("filter_bits", 1 << bf.log2_bits)
            log.metric("num_hashes", bf.num_hashes)
        else:
            bf = bloom_mod.make_bloom(8, 1, device=device)  # never queried
        job = Job(config, batch, device, mesh, timer, log, need_bloom)

        if not root:
            if not skip_front:
                mode.front(job, bf)   # what it returns is rank 0's
                if spans.follow:
                    timer.begin(spans.follow)
            mode.cover(job, None, None)
            timer.end()
            mesh_stats(mesh, timer)
            return share_result(mesh)
        if not skip_front:
            table, seed_fw, has_seed, nid, front_bf, min_pos = mode.front(
                job, bf)
        if mesh is not None:
            rank0_alone.enter_context(sharded.root_section(mesh))

        closure_rounds = simplify_drops = 0
        if not jump:
            if restored:
                d = ckpt.load(front_stage, device)
                if front_stage == "stage1":   # no filter: the driver builds it
                    table = ckpt_mod.tuple_from(count_mod.KmerTable, "table",
                                                d)
                    front_bf = None
                else:
                    table = count_mod.KmerTable(d["keys"], torch.zeros_like(
                        d["keys"][:, 0]), d["size"])
                    front_bf = (bf._replace(bits=d["bf_bits"]) if need_bloom
                                else bf)
                seed_fw, has_seed, nid = d["seed_fw"], d["has_seed"], None
                log.write(f"{front_stage} restored from checkpoint")
            elif extra_solid:
                etab, eseed = extra_solid_table(extra_solid, config, device)
                table = count_mod.merge_tables(table, etab)
                del etab
                nid = None  # node ranks shifted; coverage looks them up
                seed_fw = torch.cat([seed_fw, eseed], dim=0)
                has_seed = torch.cat([has_seed, torch.ones_like(
                    eseed[:, 0], dtype=torch.bool)])
                log.write(f"extra-solid merge: {len(extra_solid)} seqs")
            num_nodes = int(table.size)
            if ckpt is not None and not restored:
                n = max(num_nodes, 1)   # the valid prefix: compaction pads
                if front_stage == "stage1":
                    head = ckpt_mod.tuple_arrays("table", table._replace(
                        keys=table.keys[:n], counts=table.counts[:n]))
                    tail = {}
                else:   # also each read's first solid position, the filter
                    head = dict(keys=table.keys[:n], size=table.size,
                                min_pos=min_pos)
                    tail = {"bf_bits": front_bf.bits} if need_bloom else {}
                ckpt.save(front_stage, **head, seed_fw=seed_fw,
                          has_seed=has_seed, **tail)
                log.write(f"{front_stage} checkpoint saved")
            log.write(f"counted short kmer; solid nodes={num_nodes}")
            pending = need_bloom and front_bf is None
            bf = bf if front_bf is None else front_bf
            timer.begin(spans.bloom if pending else spans.graph)

            nodes = pad_table_keys(table.keys, num_nodes,
                                   graph_cap(num_nodes))
            del table
            size = torch.tensor(num_nodes, dtype=torch.int64, device=device)
            if pending:
                bf = _bloom_from_nodes(nodes, size, bf, k=config.k)
                timer.begin(spans.graph)
            if restored3:
                dbg = None  # the stage-3 checkpoint holds the final graph
            elif ckpt is not None and ckpt.has("stage2"):
                dbg = ckpt_mod.tuple_from(build_mod.DBG, "dbg",
                                          ckpt.load("stage2", device))
                log.write("stage2 restored from checkpoint")
            else:
                dbg = run_stage2(nodes, size, bf, k=config.k,
                                 use_exact=config.use_exact_membership,
                                 timer=timer)
                if not config.use_exact_membership:
                    note_bloom(timer, dbg, bf)
                    if mode.closure and config.bloom_expand_rounds:
                        dbg, nodes, size, closure_rounds = \
                            _expand_bloom_closure(dbg, nodes, size, bf,
                                                  config, log, timer)
                        if closure_rounds:
                            nid = None  # node rows shifted
                if ckpt is not None and "stage2" in mode.checkpoints:
                    ckpt.save("stage2", **ckpt_mod.tuple_arrays("dbg", dbg))
                    log.write("stage2 checkpoint saved")
            del nodes
            log.write("de bruijn graph loaded")
            timer.begin(spans.coverage)

        if restored3:
            d = ckpt.load("stage3", device)
            dbg = ckpt_mod.tuple_from(build_mod.DBG, "dbg", d)
            cov = ckpt_mod.tuple_from(cov_mod.CoverageResult, "cov", d)
            reach_jun, reach_uni, chars = (d["reach_jun"], d["reach_uni"],
                                           d["chars"])
            log.write("stage3 restored from checkpoint (skip to emission)")
            if jump:
                num_nodes = int(dbg.size)
        else:
            cov = mode.cover(job, dbg, nid)
            log.write("count node coverage")
            if spans.simplify:
                timer.begin(spans.simplify)
            if config.clip_tips or config.pop_bubbles:
                dbg, cov, simplify_drops = simplify_graph(
                    job, dbg, cov, nid, bf, functools.partial(mode.cover, job))
            if spans.reach:
                timer.begin(spans.reach)
        if mesh is not None:
            mode.cover(job, None, None)   # no coverage pass follows
        if not restored3:
            reach_jun, reach_uni, chars = reach_chars(dbg, seed_fw, has_seed,
                                                      config.k)
        timer.begin(spans.emit)
        if ckpt is not None and not restored3:
            # The final graph and stage 3: a resume goes straight to
            # emission.
            ckpt.save("stage3", **ckpt_mod.tuple_arrays("dbg", dbg),
                      **ckpt_mod.tuple_arrays("cov", cov),
                      reach_jun=reach_jun, reach_uni=reach_uni, chars=chars)
            log.write("stage3 checkpoint saved")

        result = finish(job, write_output, dbg, cov, reach_jun, reach_uni,
                        chars, solid_nodes=num_nodes,
                        closure_rounds=closure_rounds,
                        simplify_drops=simplify_drops)
        return result if mesh is None else share_result(mesh, result)


def share_result(mesh, result: Optional[AssemblyResult] = None
                 ) -> AssemblyResult:
    """Rank 0's result on every rank of a mesh, without the graph on the
    others: rank 0 passes its result, the others None."""
    shared = sharded.broadcast_object(mesh, None if result is None else (
        result.gfa_lines, result.straight_seqs, result.num_nodes,
        result.num_junctions, result.num_straights, result.stats))
    if result is not None:
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
    rank 0 before it reaches them (``sharded.root_section``)."""
    sharded.broadcast_object(mesh, "stats")
    return {"backend": mesh.backend, "world_size": mesh.size,
            "devices": mesh.devices,
            "ranks": sharded.rank_stats(mesh, timer, timer.counts())}


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


def finish(job, write_output, dbg, cov, reach_jun, reach_uni, chars, *,
           solid_nodes, closure_rounds, simplify_drops) -> AssemblyResult:
    """Stage 4 and the result: the seed-restriction override, the
    emission packs, the GFA (inside the stage-4 span the caller began),
    then span ``finish``: the counts, the N50 and the ``stats`` log line
    (on a mesh, rank 0's, with ``stats['mesh']`` gathered from every rank
    just before)."""
    config, log, timer, batch = job.config, job.log, job.timer, job.batch
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
             "device": str(job.device)}
    if job.mesh is not None:
        stats["mesh"] = mesh_stats(job.mesh, timer)
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
