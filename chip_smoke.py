#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (platanus3_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit on failure:

1. device: no CUDA device, no run; prints the card's name and power limit
   as ``nvidia-smi`` gives them;
2. build: compiles the CUDA kernels from ``platanus3_tpu_torch/csrc``;
3. kernel vs plain: ``bloom_set_bits`` (through ``ops.bloom.bloom_add``)
   against the plain PyTorch build on the card, at a small shape, at the
   main run's shape (k = 32, 2^30 bits), at that shape with k = 64 and
   k = 128 (four and eight lanes) and with 2^32, 2^33 and 2^35 bits (the
   wide positions), at the chromosome run's per-slice shape (4096 x 4072
   rows, k = 25, 2^33 bits, phase 12), and at filters from 2^5 to 2^35
   bits; the words must be bit-equal and the input filter unmodified;
   times from CUDA events, for the whole call and for each of its passes;
4. CPU/GPU parity: a 20 kb genome at 25x in Bloom mode with a filter small
   enough that the false-positive closure runs; then the same reads
   through multi-k (k = 32, 64) with tips clipped and bubbles popped in a
   2^32-bit filter; then through streaming (``assemble_streaming``, 8
   chunks a slice) in Bloom mode with the small filter, one
   ``bloom_set_bits`` launch a slice; the GFA line lists from the card and
   from the CPU (plain versions) must be identical.  Then a streaming CLI
   run on the card with ``--checkpoint-dir`` is killed after its
   ``spass2`` checkpoint (``P3_FAULT_AFTER``, exit code 137) in a
   subprocess and resumed in another; its GFA must equal an uncrashed
   run's;
5. the main run's reads: a generated genome of E. coli K-12 MG1655's
   length and GC (4,641,652 bp, 50.8 %; NCBI NC_000913.3), 20x of 10 kb
   reads with 0.1 % substitutions (BASELINE config 1), chunked as the main
   run chunks them;
6. OA counter: ``ops.count_oa.count_kmers_oa`` (kernel
   ``oa_count_insert``) on every chunk position of those reads, for the
   short k = 21 k-mers, the k = 32 ones and the k = 64 ones (about 10^8
   rows each); the kernel's table, the plain table and the sort counter's
   table must be equal, overflow 0, every slot reachable by probing;
   prints the largest block's row count and each pass's time;
7. blocked Bloom: ``ops.bloom_blocked.build_blocked_bloom`` (kernel
   ``bloom_blocked_set_bits``) on the main run's node table at 2^30 and
   2^33 bits, 10 hashes; words bit-equal to the plain build, overflow 0,
   no false negative, false-positive share on 10^6 random k-mers below
   10^-3; prints the largest block's item count, each pass's time and
   that of the scan between the count and the scatter.  Then random
   k = 64 k-mers at the same shape and 2^30 bits, and the skewed blocks
   at 2^30 bits: 200,000 distinct k-mers all in block 0, and 200,000
   copies of one k-mer, each bit-equal to the plain build with overflow 0
   and no false negative;
8. main run: those reads, written as FASTA, through the port's
   ``cli.main`` with ``-k 32 -m 1073741824 --membership bloom`` (the read
   file loaded by the C++ loader, whose ``load`` span is printed); checks
   the launch count and that the straights cover >= 0.9 of the genome,
   >= 0.9 of their bases as exact genome substrings.  Then the same run
   with ``--trace-dir``: ``bloom_set_bits`` must be among the trace's CUDA
   kernels, and the device's busy share of the traced window is printed;
9. multi-k run: the same reads through ``cli.main`` with ``--k-list
   32,64,128 --clip-tips --pop-bubbles --membership bloom -m 8589934592``
   (BASELINE configs 4 and 3, a 2^33-bit filter); checks one
   ``bloom_set_bits`` launch a round and that the last round's straights
   cover >= 0.9 of the genome; prints each round's nodes, straights,
   junctions, N50, simplification drops, stage spans (the simplification
   split into its parts) and peak device memory.  The share of exact
   genome substrings is printed, not held to 0.9: the bubble rule of the
   JAX package, which the port keeps, pops the loop arm of tandem arrays
   (ROADMAP.md Queue 3).  The witness is the same run without
   ``--pop-bubbles``, held to both quality bounds;
10. E. coli streaming: phase 8's arguments plus ``--streaming
    --slice-chunks 2048``.  Phase 8's Bloom closure must have added no
    node (streaming runs none); then the GFA must equal phase 8's line for
    line, with one ``bloom_set_bits`` launch a slice; prints the spans and
    peak memory;
11. threshold sweep (BASELINE config 2): ``sweep.solid_threshold_sweep``
    on the main reads at k = 32, thresholds 1, 2, 3, 4, 6 and 8, against
    the genome; ``n_solid`` must not rise with the threshold and the best
    F1 must be >= 0.95; prints every row;
12. chromosome-sized streaming (BASELINE config 5 on one card): the
    recipe of ``benchmarks/chr21_stream.py`` (a random 46.7 Mb genome,
    seed 0; 12x of 8 kb reads with 0.2 % substitutions, seed 1; about 560
    Mbases) through ``cli.main --streaming -k 25 --cov-threshold 3
    --chunk-len 4096 --slice-chunks 4096 --membership bloom -m
    8589934592``; the straights must cover >= 0.9 of the genome, >= 0.9
    of their bases as exact genome substrings, with one ``bloom_set_bits``
    launch a slice and a peak below 80 GB of device memory; prints every
    span and its peak, nodes, straights, junctions and N50.

Phases 6-12 each drive their path with the kernels' launch counts set to
0 just before and read just after; launches made to compare a kernel with
its plain version or to time it are not counted.  The second-to-last line
is the kernels' JSON (times from CUDA events, bounds from this run's
shapes), the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

GENOME_LEN = 4_641_652        # E. coli K-12 MG1655, NC_000913.3
GENOME_GC = 0.508
MAIN_FILTER_BITS = 1 << 30
MAIN_HASHES = 10
MAIN_K, SHORT_K, CHUNK_LEN, COV_THRESHOLD = 32, 21, 1024, 2
MULTIK_K_LIST = (32, 64, 128)
MULTIK_FILTER_BITS = 1 << 33
BLOCKED_LOG2_BITS = (30, 33)
BLOOM_CHECK_LOG2_BITS = (5, 10, 19, 20, 31, 32, 35)
# (k, log2_bits) of bloom_set_bits at the main shape: the main run's,
# then more lanes, then the wide positions, then the multi-k run's last.
BLOOM_MAIN_SHAPES = ((32, 30), (64, 30), (128, 30), (32, 32), (32, 33),
                     (32, 35), (128, 33))
OA_KS = (SHORT_K, MAIN_K, 64)
# The chromosome-sized streaming run (phase 12): benchmarks/chr21_stream.py's
# recipe, and the per-slice shape of its bloom_set_bits launches (4096
# chunks of 4096 bases, 4072 k = 25 positions each).
CHR21_GENOME_LEN = 46_700_000
CHR21_ARGS = ["--streaming", "-k", "25", "--cov-threshold", "3",
              "--chunk-len", "4096", "--slice-chunks", "4096",
              "--membership", "bloom", "-m", str(1 << 33)]
CHR21_SLICE_CHUNKS = 4096
SLICE_ROWS = 4096 * (4096 - 25 + 1)
ECOLI_SLICE_CHUNKS = 2048
SWEEP_THRESHOLDS = (1, 2, 3, 4, 6, 8)
DEVICE_BYTES_LIMIT = 80e9
# Events of the device in a torch.profiler Chrome trace; bloom_set_bits
# is the only caller of the region OR kernel.
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BLOOM_SET_BITS_KERNEL = "bloom_region_or_kernel"
WIDE_BLOCKED_K = 64
FP_PROBES = 1_000_000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 peak bandwidth
BLOOM_SOURCE = "platanus3_tpu_torch/csrc/bloom.cu"
OA_SOURCE = "platanus3_tpu_torch/csrc/count_oa.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pass_times_ms(make_passes, reps: int) -> dict:
    """Mean device time of each pass of a wrapper's pass generator
    (``kernels.run_passes``) over ``reps`` runs, after one warm-up.  A
    pass's time runs from the end of the one before it, so it includes
    the wrapper's allocations and scan ahead of its launch."""
    import torch
    from platanus3_tpu_torch import kernels
    kernels.run_passes(make_passes())
    runs = []
    for _ in range(reps):
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()
        for name in make_passes():
            marks.append((name, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()
        runs.append(marks)
    torch.cuda.synchronize()
    return {name: sum(run[i - 1][1].elapsed_time(run[i][1])
                      for run in runs) / reps
            for i, (name, _) in enumerate(runs[0]) if i}


def fmt_passes(times: dict) -> str:
    return ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())


def random_canon(rows: int, k: int, seed: int, device):
    """Canonical random k-mers ``[rows, L]`` with one row in four a
    duplicate of another row."""
    import torch
    from platanus3_tpu_torch.ops import kmer
    gen = torch.Generator(device=device).manual_seed(seed)
    lanes = torch.randint(0, 1 << 32, (rows, kmer.num_lanes(k)),
                          generator=gen, device=device, dtype=torch.int64)
    lanes[:, 0] &= kmer._top_mask(k)
    dup = torch.randint(0, rows, (2, rows // 4), generator=gen,
                        device=device)
    lanes[dup[0]] = lanes[dup[1]]
    return kmer.canonical(lanes, k)[0]


def bytes_bound_ms(nbytes: int) -> float:
    """Least time to move ``nbytes`` through device memory, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 bound, library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library_ms}


def kernel_vs_plain(rows, valid_rows, k, log2_bits, hashes, seed, reps,
                    plain_reps=None):
    """Kernel and plain build on the same inputs: (max_abs_err, ms,
    plain_ms, bound_ms, per-pass ms).  The bound reads the lanes, the mask
    and the old words once and writes the words once."""
    import torch
    from platanus3_tpu_torch.ops import bloom
    dev = torch.device("cuda")
    canon = random_canon(rows, k, seed, dev)
    mask = torch.arange(rows, device=dev) < valid_rows
    empty = bloom.make_bloom(1 << log2_bits, hashes, device=dev)
    old = empty.bits.clone()
    got = bloom.bloom_add(empty, canon, k, mask=mask)
    want = bloom.bloom_add_plain(empty, canon, k, mask=mask)
    torch.cuda.synchronize()
    if not torch.equal(empty.bits, old):
        raise AssertionError("bloom_set_bits modified its input filter")
    del old
    err = int((got.bits.long() - want.bits.long()).abs().max())
    if not torch.equal(got.bits, want.bits) or err != 0:
        raise AssertionError(f"bloom_set_bits differs from the plain build "
                             f"at rows={rows} k={k} 2^{log2_bits} bits: "
                             f"max_abs_err={err}")
    if int(got.bits.ne(0).sum()) == 0:
        raise AssertionError("kernel set no bit")
    bound = bytes_bound_ms(nbytes(canon, mask, empty.bits, got.bits))
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: bloom.bloom_add(empty, canon, k, mask=mask),
                      reps)
    plain_ms = cuda_time_ms(
        lambda: bloom.bloom_add_plain(empty, canon, k, mask=mask),
        plain_reps or reps)
    passes = pass_times_ms(
        lambda: bloom.bloom_add_passes(empty, canon, k, mask), reps)
    del canon, mask, empty
    torch.cuda.empty_cache()
    return err, ms, plain_ms, bound, passes


def bloom_main_shapes(rows):
    """``bloom_set_bits`` at the main shape (``rows`` rows, the genome's
    length of them masked in, 10 hashes) for each of BLOOM_MAIN_SHAPES.
    Returns one measurement dict a shape."""
    out = []
    for k, lb in BLOOM_MAIN_SHAPES:
        err, ms, plain_ms, bound, passes = kernel_vs_plain(
            rows, GENOME_LEN, k, lb, MAIN_HASHES, seed=2, reps=10,
            plain_reps=3)
        shape = f"{rows} rows, {GENOME_LEN} masked in, k={k}, 2^{lb} bits, " \
                f"{MAIN_HASHES} hashes"
        log(f"kernel main shape ({shape}): max_abs_err {err}, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms")
        log(f"kernel main shape k={k} 2^{lb} passes: {fmt_passes(passes)}")
        out.append({"shape": shape, "k": k, "log2_bits": lb,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "library_ms": None,
                    "passes": passes})
    return out


def bloom_slice_shape():
    """``bloom_set_bits`` at the per-slice shape of the chromosome run:
    4096 chunks x 4072 k = 25 positions, all masked in, a 2^33-bit
    filter, 10 hashes.  Returns its measurement dict."""
    err, ms, plain_ms, bound, passes = kernel_vs_plain(
        SLICE_ROWS, SLICE_ROWS, 25, 33, MAIN_HASHES, seed=5, reps=10,
        plain_reps=3)
    shape = f"{SLICE_ROWS} rows (4096 x 4072), all masked in, k=25, 2^33 " \
            f"bits, {MAIN_HASHES} hashes"
    log(f"kernel slice shape ({shape}): max_abs_err {err}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms")
    log(f"kernel slice shape passes: {fmt_passes(passes)}")
    return {"shape": shape, "k": 25, "log2_bits": 33, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "library_ms": None, "passes": passes}


def bloom_sizes_check(rows=200_000, k=25, hashes=4) -> int:
    """``bloom_set_bits`` at each size of BLOOM_CHECK_LOG2_BITS, from one
    word (a region smaller than 64 KB) to 2^31 bits: half the rows onto an
    empty filter, the other half onto the result.  The words must be
    bit-equal to the plain build's and the input filters unmodified.
    Returns max_abs_err."""
    import torch
    from platanus3_tpu_torch.ops import bloom
    dev = torch.device("cuda")
    half = rows // 2
    for lb in BLOOM_CHECK_LOG2_BITS:
        canon = random_canon(rows, k, seed=lb, device=dev)
        mask = torch.arange(rows, device=dev) % 10 != 3
        bf = bloom.make_bloom(1 << lb, hashes, device=dev)
        first = bloom.bloom_add(bf, canon[:half], k, mask=mask[:half])
        old = first.bits.clone()
        got = bloom.bloom_add(first, canon[half:], k, mask=mask[half:])
        want = bloom.bloom_add_plain(
            bloom.bloom_add_plain(bf, canon[:half], k, mask=mask[:half]),
            canon[half:], k, mask=mask[half:])
        torch.cuda.synchronize()
        if not torch.equal(first.bits, old) or int(bf.bits.ne(0).sum()):
            raise AssertionError(f"bloom_set_bits modified its input filter "
                                 f"at 2^{lb} bits")
        err = int((got.bits.long() - want.bits.long()).abs().max())
        if err != 0 or not torch.equal(got.bits, want.bits):
            raise AssertionError(f"bloom_set_bits differs from the plain "
                                 f"build at 2^{lb} bits: max_abs_err={err}")
    return 0


def parity_run():
    """Bloom-mode assembly of a small read set on the card and on the CPU;
    the GFA line lists must be identical."""
    from platanus3_tpu_torch import sim
    from platanus3_tpu_torch.config import AssemblyConfig
    from platanus3_tpu_torch.pipeline import assemble
    genome = sim.random_genome(20_000, seed=7)
    reads = sim.simulate_reads(genome, coverage=25, read_len=1000, seed=8,
                               sub_rate=0.01)
    # 2^18 bits, 2 hashes: ~2 % false positives on these 23k nodes, so the
    # closure adds phantom nodes for a few rounds and then converges.
    cfg = dict(k=25, use_exact_membership=False, filter_bits=1 << 18,
               num_hashes=2, log_path=None)
    gpu = assemble(reads, AssemblyConfig(**cfg), write_output=False,
                   device="cuda")
    cpu = assemble(reads, AssemblyConfig(**cfg), write_output=False,
                   device="cpu")
    if gpu.gfa_lines != cpu.gfa_lines:
        raise AssertionError("GPU and CPU GFA differ")
    if gpu.stats["closure_rounds"] < 1:
        raise AssertionError("the false-positive closure did not run")
    return gpu


def multik_parity_run():
    """The parity run's reads through multi-k (k = 32, then 64) with tips
    clipped and bubbles popped, Bloom membership in a 2^32-bit filter (the
    wide positions), on the card and on the CPU; the GFA line lists must be
    identical and the card must launch ``bloom_set_bits`` once a round."""
    from platanus3_tpu_torch import sim
    from platanus3_tpu_torch.config import AssemblyConfig
    from platanus3_tpu_torch.graph.multik import assemble_multik
    from platanus3_tpu_torch.ops import bloom
    genome = sim.random_genome(20_000, seed=7)
    reads = sim.simulate_reads(genome, coverage=25, read_len=1000, seed=8,
                               sub_rate=0.01)
    cfg = AssemblyConfig(k=32, k_list=(32, 64), clip_tips=True,
                         pop_bubbles=True, use_exact_membership=False,
                         filter_bits=1 << 32, log_path=None)
    before = bloom.bloom_add.kernel_launches
    gpu = assemble_multik(reads, cfg, write_output=False, device="cuda")
    if bloom.bloom_add.kernel_launches != before + 2:
        raise AssertionError("multi-k parity: not one bloom_set_bits launch "
                             "a round")
    cpu = assemble_multik(reads, cfg, write_output=False, device="cpu")
    if gpu.gfa_lines != cpu.gfa_lines:
        raise AssertionError("multi-k parity: GPU and CPU GFA differ")
    if gpu.num_straights < 1:
        raise AssertionError("multi-k parity: no straight")
    return gpu


def main_reads(genome_len: int = GENOME_LEN, device: str = "cuda"):
    """The main run's genome and reads, and the reads chunked on the card
    as the main run chunks them: ``(genome, reads, chunk arrays)``."""
    import torch
    from platanus3_tpu_torch import sim
    from platanus3_tpu_torch.io import reads as reads_mod
    t0 = time.time()
    genome = sim.realistic_genome(genome_len, seed=1, gc=GENOME_GC)
    reads = sim.simulate_reads(genome, coverage=20, read_len=10_000, seed=2,
                               sub_rate=0.001)
    batch = reads_mod.reads_from_strings(reads, MAIN_K, CHUNK_LEN)
    arrays = {f: torch.from_numpy(getattr(batch, f).astype("int64"))
              .to(device) for f in ("packed", "valid_len", "read_id",
                                    "start", "read_len")}
    arrays["stride"] = batch.stride
    arrays["num_reads"] = batch.num_reads
    log(f"reads: {len(reads)} reads, {sum(map(len, reads))} bases, "
        f"{batch.num_chunks} chunks, generated and chunked in "
        f"{time.time() - t0:.1f} s (host)")
    return genome, reads, arrays


def oa_phase(arrays):
    """The OA counter on every chunk position of the main run's reads, for
    the short k-mers, the k = 32 ones and the k = 64 ones (two order
    words, rows of four lanes).  Returns (launches, max_abs_err, per-set
    measurements)."""
    import torch
    from platanus3_tpu_torch.ops import count as count_mod
    from platanus3_tpu_torch.ops import count_oa, hashing, kmer, solid
    bases = kmer.unpack_bases(arrays["packed"])
    launches, err, sets = 0, 0, {}
    for kk in OA_KS:
        canon, _, owned = solid.short_kmer_positions(
            bases, arrays["valid_len"], arrays["start"], arrays["read_len"],
            arrays["stride"], kk, MAIN_K)
        canon = canon.reshape(-1, canon.shape[-1])
        contrib = owned.reshape(-1)     # owned & valid
        del owned
        count_oa.count_kmers_oa.kernel_launches = 0
        table = count_oa.count_kmers_oa(canon, contrib, kk)
        torch.cuda.synchronize()
        launches += count_oa.count_kmers_oa.kernel_launches
        g = count_oa.table_log2_blocks(canon.shape[0])
        block = hashing.hash_kmers(canon[contrib], kk, hashing.SEED_H1)
        block = block >> (32 - g) if g else torch.zeros_like(block)
        largest = int(torch.bincount(block, minlength=1 << g).max())
        del block

        plain = count_oa.count_kmers_oa_plain(canon, contrib, kk)
        if int(table.overflow) or int(plain.overflow):
            raise AssertionError(f"OA k={kk}: overflow kernel "
                                 f"{int(table.overflow)} plain "
                                 f"{int(plain.overflow)}")
        bad = count_oa.probe_violations(table, kk)
        if bad:
            raise AssertionError(f"OA k={kk}: {bad} kernel slots not "
                                 f"reachable by probing")
        got, want = count_oa.oa_to_sorted(table), count_oa.oa_to_sorted(plain)
        for a, b in zip(got, want):
            err = max(err, int((a - b).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"OA k={kk}: kernel and plain tables "
                                     f"differ")
        ref = count_mod.count_kmers(canon, contrib, k=kk)
        n = int(ref.size)
        if int(got.size) != n or not torch.equal(got.keys[:n], ref.keys[:n]) \
                or not torch.equal(got.counts[:n], ref.counts[:n]):
            raise AssertionError(f"OA k={kk}: table differs from the sort "
                                 f"counter's")
        del got, want, ref, plain
        okeys = count_mod.order_keys(canon)[contrib]
        if okeys.shape[1] == 1:
            okeys = okeys[:, 0]
        m = {"rows": canon.shape[0], "contributing": int(contrib.sum()),
             "unique": n, "slots": table.counts.shape[0],
             "largest_bucket": largest,
             "mean_bucket": int(contrib.sum()) / (1 << g),
             "bound_ms": bytes_bound_ms(nbytes(canon, contrib, table.keys,
                                               table.counts, table.overflow))}
        del table
        m["ms"] = cuda_time_ms(
            lambda: count_oa.count_kmers_oa(canon, contrib, kk), 5)
        m["passes"] = pass_times_ms(
            lambda: count_oa.oa_passes(canon, contrib, kk), 5)
        m["plain_ms"] = cuda_time_ms(
            lambda: count_oa.count_kmers_oa_plain(canon, contrib, kk),
            3 if okeys.dim() == 1 else 1)
        m["unique_ms"] = cuda_time_ms(
            lambda: torch.unique(okeys, dim=0 if okeys.dim() > 1 else None,
                                 return_counts=True), 5)
        m["sort_counter_ms"] = cuda_time_ms(
            lambda: count_mod.count_kmers(canon, contrib, k=kk), 5)
        del okeys, canon, contrib
        torch.cuda.empty_cache()
        log(f"oa k={kk}: {m['rows']} rows, {m['contributing']} "
            f"contributing, {m['unique']} unique in {m['slots']} slots; "
            f"kernel = plain = sort counter, overflow 0, probe chains "
            f"intact; largest bucket {largest} rows (mean "
            f"{m['mean_bucket']:.1f}); kernel {m['ms']:.4f} ms, plain "
            f"{m['plain_ms']:.4f} ms, torch.unique {m['unique_ms']:.4f} ms, "
            f"sort counter count_kmers {m['sort_counter_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms")
        log(f"oa k={kk} passes: {fmt_passes(m['passes'])}")
        sets[kk] = m
    return launches, err, sets


def check_blocked(kmers, mask, log2_bits: int, what: str, k: int = MAIN_K):
    """``build_blocked_bloom`` on the card against the plain build: words
    bit-equal, overflow 0, one launch, every masked-in k-mer a member.
    Returns (words, max_abs_err)."""
    import torch
    from platanus3_tpu_torch.ops import bloom_blocked
    before = bloom_blocked.build_blocked_bloom.kernel_launches
    words, ovf = bloom_blocked.build_blocked_bloom(
        kmers, k, mask, log2_bits, MAIN_HASHES, return_overflow=True)
    torch.cuda.synchronize()
    if bloom_blocked.build_blocked_bloom.kernel_launches != before + 1:
        raise AssertionError(f"blocked {what}: not one launch")
    plain = bloom_blocked.build_blocked_bloom_plain(
        kmers, k, mask, log2_bits, MAIN_HASHES)
    err = int((words.long() - plain.long()).abs().max())
    if err != 0 or not torch.equal(words, plain) or int(ovf) != 0:
        raise AssertionError(f"blocked {what}: kernel words differ from the "
                             f"plain build (max_abs_err {err}, overflow "
                             f"{int(ovf)})")
    inserted = kmers if mask is None else kmers[mask]
    if not bool(bloom_blocked.query_blocked(
            words, inserted, k, log2_bits, MAIN_HASHES).all()):
        raise AssertionError(f"blocked {what}: an inserted k-mer is missing")
    return words, err


def block_of(kmers, log2_bits: int):
    """Each k-mer's block in a ``2^log2_bits``-bit blocked filter."""
    from platanus3_tpu_torch.ops import hashing
    h1 = hashing.hash_kmers(kmers, MAIN_K, hashing.SEED_H1)
    return h1 >> (32 - (log2_bits - 19))


def blocked_skew_check(log2_bits: int = 30, rows: int = 200_000) -> int:
    """The blocked build with every row in block 0: ``rows`` distinct
    random k-mers picked for their block, then ``rows`` copies of one
    k-mer.  Returns max_abs_err (0)."""
    import torch
    dev = torch.device("cuda")
    distinct = torch.empty((0, 2), dtype=torch.int64, device=dev)
    seed = 100
    while distinct.shape[0] < rows:
        pool = random_canon(1 << 25, MAIN_K, seed, dev)
        distinct = torch.cat([distinct, pool[block_of(pool, log2_bits) == 0]]
                             ).unique(dim=0)
        seed += 1
    words, err = check_blocked(distinct, None, log2_bits, "skew, distinct")
    if int(words[1 << 14:].ne(0).sum()):
        raise AssertionError("skew: a bit set outside block 0")
    copies = distinct[:1].expand(rows, -1).contiguous()
    return max(err, check_blocked(copies, None, log2_bits, "skew, copies")[1])


def blocked_phase(arrays):
    """The blocked Bloom build of the main run's node table (stage 1 of
    the main run, padded to the graph capacity as the main run's filter
    input), then the skewed blocks.  Returns (launches, max_abs_err,
    per-size measurements)."""
    import torch
    from platanus3_tpu_torch import kernels
    from platanus3_tpu_torch.ops import bloom_blocked
    from platanus3_tpu_torch.pipeline import (graph_cap, pad_table_keys,
                                              _stage1)
    table, _, _, _ = _stage1(
        arrays["packed"], arrays["valid_len"], arrays["read_id"],
        arrays["start"], arrays["read_len"], COV_THRESHOLD, k=MAIN_K,
        short_k=SHORT_K, num_reads=arrays["num_reads"])
    size = int(table.size)
    nodes = pad_table_keys(table.keys, size, graph_cap(size)).contiguous()
    del table
    mask = torch.arange(nodes.shape[0], device=nodes.device) < size
    probes = random_canon(FP_PROBES, MAIN_K, seed=3, device=nodes.device)
    launches, err, sizes = 0, 0, {}
    for lb in BLOCKED_LOG2_BITS:
        bloom_blocked.build_blocked_bloom.kernel_launches = 0
        words, lb_err = check_blocked(nodes, mask, lb, f"2^{lb}")
        launches += bloom_blocked.build_blocked_bloom.kernel_launches
        err = max(err, lb_err)
        fp = float(bloom_blocked.query_blocked(
            words, probes, MAIN_K, lb, MAIN_HASHES).double().mean())
        if fp >= 1e-3:
            raise AssertionError(f"blocked 2^{lb}: false-positive share "
                                 f"{fp} >= 1e-3")
        blocks = 1 << (lb - 19)
        largest = int(torch.bincount(block_of(nodes[:size], lb),
                                     minlength=blocks).max())
        m = {"nodes": size, "rows": nodes.shape[0], "fp_share": fp,
             "largest_block": largest, "mean_block": size / blocks,
             "bound_ms": bytes_bound_ms(nbytes(nodes, mask, words))}
        del words
        m["ms"] = cuda_time_ms(lambda: bloom_blocked.build_blocked_bloom(
            nodes, MAIN_K, mask, lb, MAIN_HASHES), 10)
        m["passes"] = pass_times_ms(
            lambda: bloom_blocked.build_blocked_bloom_passes(
                nodes, MAIN_K, mask, lb, MAIN_HASHES), 10)
        # The scatter pass's time includes this scan of the counts, a few
        # small PyTorch launches from the host.
        hist = torch.zeros((kernels.partition_ctas(nodes.device),
                            1 << bloom_blocked.blocked_layout(lb)[0]),
                           dtype=torch.int32, device=nodes.device)
        m["scan_ms"] = cuda_time_ms(lambda: kernels.partition_offsets(hist),
                                    10)
        m["plain_ms"] = cuda_time_ms(
            lambda: bloom_blocked.build_blocked_bloom_plain(
                nodes, MAIN_K, mask, lb, MAIN_HASHES), 5)
        torch.cuda.empty_cache()
        log(f"blocked 2^{lb} bits, {MAIN_HASHES} hashes: {m['rows']} rows, "
            f"{size} nodes; words bit-equal, overflow 0, no false negative, "
            f"false-positive share {fp} on {FP_PROBES} random k-mers; "
            f"largest block {largest} items (mean {m['mean_block']:.1f}); "
            f"kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, bound "
            f"{m['bound_ms']:.4f} ms")
        log(f"blocked 2^{lb} passes: {fmt_passes(m['passes'])}; the scan "
            f"between count and scatter alone {m['scan_ms']:.4f} ms")
        sizes[lb] = m
    rows = nodes.shape[0]
    del nodes, mask, probes
    torch.cuda.empty_cache()
    wide = random_canon(rows, WIDE_BLOCKED_K, seed=4, device="cuda")
    mask = torch.arange(rows, device=wide.device) < size
    lb = BLOCKED_LOG2_BITS[0]
    bloom_blocked.build_blocked_bloom.kernel_launches = 0
    words, wide_err = check_blocked(wide, mask, lb, f"k={WIDE_BLOCKED_K}",
                                    k=WIDE_BLOCKED_K)
    launches += bloom_blocked.build_blocked_bloom.kernel_launches
    err = max(err, wide_err)
    m = {"rows": rows, "bound_ms": bytes_bound_ms(nbytes(wide, mask, words))}
    del words
    m["ms"] = cuda_time_ms(lambda: bloom_blocked.build_blocked_bloom(
        wide, WIDE_BLOCKED_K, mask, lb, MAIN_HASHES), 10)
    m["plain_ms"] = cuda_time_ms(
        lambda: bloom_blocked.build_blocked_bloom_plain(
            wide, WIDE_BLOCKED_K, mask, lb, MAIN_HASHES), 5)
    log(f"blocked k={WIDE_BLOCKED_K} 2^{lb} bits: {rows} random rows, "
        f"{size} masked in; words bit-equal, overflow 0, no false negative; "
        f"kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, bound "
        f"{m['bound_ms']:.4f} ms")
    sizes[f"k{WIDE_BLOCKED_K}"] = m
    del wide, mask
    torch.cuda.empty_cache()
    err = max(err, blocked_skew_check())
    log("blocked skew at 2^30 bits: 200000 distinct k-mers in block 0 and "
        "200000 copies of one k-mer, each bit-equal to the plain build, "
        "overflow 0, no false negative, one launch")
    return launches, err, sizes


def run_stats(run_log: Path) -> list:
    """The stats line of every ``assemble`` call in a run log."""
    return [json.loads(line.split("] stats ", 1)[1])
            for line in run_log.read_text().splitlines()
            if "] stats {" in line]


def exact_substring_bases(straights, genome: str, w: int = 24) -> int:
    """Bases of ``straights`` that are exact substrings of the genome or
    of its reverse complement.  Each straight's first w-mer, in both
    orientations, is looked up in a sorted index of the genome's w-mers,
    and each hit is compared base for base; a scan of the genome per
    straight would take minutes at chromosome size."""
    import numpy as np
    from platanus3_tpu_torch import sim
    lut = np.zeros(256, np.int64)
    for i, c in enumerate("ACGT"):
        lut[ord(c)] = i

    def wmers(seq: str):
        codes = lut[np.frombuffer(seq.encode(), np.uint8)]
        n = codes.shape[0] - w + 1
        v = np.zeros(n, np.int64)
        for j in range(w):
            v = (v << 2) | codes[j:j + n]
        return v

    index = wmers(genome)
    order = np.argsort(index, kind="stable")
    ordered = index[order]
    del index
    exact = 0
    for x in straights:
        found = False
        for cand in (x, sim.revcomp(x)):
            if len(cand) < w:
                found = cand in genome
            else:
                key = wmers(cand[:w])[0]
                lo, hi = np.searchsorted(ordered, [key, key + 1])
                found = any(genome[p:p + len(cand)] == cand
                            for p in order[lo:hi].tolist())
            if found:
                break
        exact += len(x) if found else 0
    return exact


def check_quality(gfa: Path, genome: str, what: str,
                  hold_exact: bool = True):
    """Straight length sum against the genome and the share of straight
    bases that are exact genome substrings; the first must be >= 0.9, and
    the second too with ``hold_exact``.  Returns (straights, junctions,
    length sum, N50, exact share)."""
    from platanus3_tpu_torch.pipeline import _n50 as n50
    lines = gfa.read_text().splitlines()
    straights = [ln.split("\t")[2] for ln in lines
                 if ln.startswith("S\tStraight")]
    n_jun = sum(1 for ln in lines if ln.startswith("S\tJunction"))
    lengths = [len(x) for x in straights]
    total = sum(lengths)
    exact = exact_substring_bases(straights, genome)
    share = exact / max(total, 1)
    log(f"{what}: straight length sum {total} "
        f"({total / len(genome):.4f} of the genome), N50 {n50(lengths)}, "
        f"exact-substring share {share:.4f}")
    if total < 0.9 * len(genome):
        raise AssertionError(f"{what}: straights cover {total} < 0.9 x "
                             f"{len(genome)}")
    if hold_exact and exact < 0.9 * total:
        raise AssertionError(f"{what}: only {exact} of {total} straight "
                             f"bases are exact genome substrings")
    return len(straights), n_jun, total, n50(lengths), share


def cli_run(workdir: Path, fasta: Path, args, device: str = "cuda"):
    """``cli.main`` on ``fasta`` with ``args``, with ``bloom_set_bits``'s
    launch count set to 0 just before and read just after.  Returns
    (wall s, launches, GFA path, stats of every round)."""
    import torch
    from platanus3_tpu_torch import cli
    from platanus3_tpu_torch.ops import bloom

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    gfa, run_log = workdir / "out.gfa", workdir / "run.log"
    run_log.unlink(missing_ok=True)
    bloom.bloom_add.kernel_launches = 0
    sync()
    t1 = time.time()
    rc = cli.main(["-i", str(fasta), *args, "-o", str(gfa), "--log",
                   str(run_log), "--profile-stages", "--device", device])
    sync()
    wall = time.time() - t1
    launches = bloom.bloom_add.kernel_launches
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    stats = run_stats(run_log)
    if not stats:
        raise AssertionError("no stats line in the run log")
    return wall, launches, gfa, stats


MAIN_ARGS = ["-k", "32", "-m", str(MAIN_FILTER_BITS), "--membership",
             "bloom"]


def main_run(workdir: Path, genome: str, fasta: Path, device: str = "cuda"):
    """Phase 8's run.  Returns (launches, stats, a copy of its GFA)."""
    wall, launches, gfa, (stats,) = cli_run(workdir, fasta, MAIN_ARGS,
                                            device)
    log(f"main: cli wall {wall:.3f} s; stages (s): "
        + json.dumps(stats["stages"]))
    log(f"main: load span (C++ read loader) {stats['stages']['load']:.4f} s")
    log("main: peak device memory per stage (bytes): "
        + json.dumps(stats.get("peak_bytes", {})))
    n_s, n_jun, _, _, _ = check_quality(gfa, genome, "main")
    log(f"main: solid nodes {stats['solid_nodes']}, graph nodes "
        f"{stats['graph_nodes']}, straights {n_s}, junctions "
        f"{n_jun}, closure rounds {stats['closure_rounds']}")
    log(f"main: bloom_set_bits launches {launches}")
    if device == "cuda" and launches < 1:
        raise AssertionError("the main run never launched bloom_set_bits")
    kept = workdir / "main.gfa"
    shutil.copyfile(gfa, kept)
    return launches, stats, kept


def trace_summary(trace: Path) -> dict:
    """Device activity in a ``torch.profiler`` Chrome trace: the traced
    window (the event ``device_trace`` opens around the whole run), the
    union of the device's kernel, copy and set intervals within it, the
    region-OR launches of ``bloom_set_bits``, and device time by kernel
    name."""
    from platanus3_tpu_torch.utils.profiling import TRACE_WINDOW
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
    (window,) = [e for e in events if e.get("name") == TRACE_WINDOW
                 and e.get("cat") == "user_annotation"]
    start = float(window["ts"])
    end = start + float(window["dur"])
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in events if e.get("cat") in DEVICE_EVENT_CATS)
    busy, reach = 0.0, start
    for lo, hi in device:
        lo = max(lo, reach)
        if hi > lo:
            busy += hi - lo
            reach = hi
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(
                e.get("dur", 0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"window_s": (end - start) / 1e6, "busy_s": busy / 1e6,
            "busy_share": busy / max(end - start, 1e-9),
            "device_events": len(device),
            "bloom_region_or_launches": sum(
                1 for e in events if e.get("cat") == "kernel"
                and BLOOM_SET_BITS_KERNEL in e["name"]),
            "top_kernels_ms": [(name[:90], t / 1e3) for name, t in top]}


def traced_main_run(workdir: Path, fasta: Path):
    """Phase 8 again with ``--trace-dir``: ``bloom_set_bits`` must be
    among the trace's kernels.  Returns (launches, trace summary)."""
    trace_dir = workdir / "trace"
    wall, launches, _, (stats,) = cli_run(
        workdir, fasta, MAIN_ARGS + ["--trace-dir", str(trace_dir)])
    from platanus3_tpu_torch.utils.profiling import TRACE_FILE
    trace = trace_dir / TRACE_FILE
    summary = trace_summary(trace)
    log(f"main traced: cli wall {wall:.3f} s, trace {trace.stat().st_size} "
        f"bytes; traced window {summary['window_s']:.4f} s, device busy "
        f"{summary['busy_s']:.4f} s = busy share {summary['busy_share']:.4f}"
        f" ({summary['device_events']} device events); bloom_set_bits "
        f"region-OR kernels in the trace {summary['bloom_region_or_launches']}"
        f", launches counted {launches}")
    log("main traced: device time by kernel (ms): "
        + json.dumps(summary["top_kernels_ms"]))
    log("main traced: stages (s) " + json.dumps(stats["stages"]))
    if summary["bloom_region_or_launches"] != launches or launches < 1:
        raise AssertionError("the trace does not show the bloom_set_bits "
                             "launches of the run")
    shutil.rmtree(trace_dir)
    return launches, summary


def streaming_parity_run(workdir: Path):
    """The parity run's reads through streaming, 8 chunks a slice, in
    Bloom mode with the small filter, on the card and on the CPU; then a
    crash after ``spass2`` and a resume on the card, in subprocesses.
    Returns (slices, card GFA lines)."""
    from platanus3_tpu_torch import cli, sim
    from platanus3_tpu_torch.config import AssemblyConfig
    from platanus3_tpu_torch.io import reads as reads_mod
    from platanus3_tpu_torch.ops import bloom
    from platanus3_tpu_torch.streaming import assemble_streaming
    genome = sim.random_genome(20_000, seed=7)
    reads = sim.simulate_reads(genome, coverage=25, read_len=1000, seed=8,
                               sub_rate=0.01)
    cfg = AssemblyConfig(k=25, use_exact_membership=False,
                         filter_bits=1 << 18, num_hashes=2, log_path=None)
    chunks = reads_mod.reads_from_strings(reads, 25, cfg.chunk_len).num_chunks
    slices = -(-chunks // 8)
    before = bloom.bloom_add.kernel_launches
    gpu = assemble_streaming(reads, cfg, write_output=False, slice_chunks=8,
                             device="cuda")
    if bloom.bloom_add.kernel_launches - before != slices:
        raise AssertionError("streaming parity: not one bloom_set_bits "
                             "launch a slice")
    cpu = assemble_streaming(reads, cfg, write_output=False, slice_chunks=8,
                             device="cpu")
    if gpu.gfa_lines != cpu.gfa_lines:
        raise AssertionError("streaming parity: GPU and CPU GFA differ")
    if gpu.num_straights < 1:
        raise AssertionError("streaming parity: no straight")

    fasta = workdir / "parity.fasta"
    fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    args = ["-i", str(fasta), "--streaming", "--slice-chunks", "8",
            "--membership", "bloom", "-m", str(1 << 18), "--log", ""]
    plain_gfa = workdir / "uncrashed.gfa"
    if cli.main(args + ["-o", str(plain_gfa)]) != 0:
        raise AssertionError("streaming parity: uncrashed CLI run failed")
    ckpt, resumed = workdir / "ckpt", workdir / "resumed.gfa"
    cmd = [sys.executable, "-m", "platanus3_tpu_torch.cli", *args,
           "--checkpoint-dir", str(ckpt), "-o", str(resumed)]
    env = dict(os.environ, P3_FAULT_AFTER="spass2")
    crash = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
    if crash.returncode != 137 or not list(ckpt.glob("*/spass2.npz")):
        raise AssertionError(f"streaming crash: exit code "
                             f"{crash.returncode}, not 137 after spass2\n"
                             f"{crash.stderr[-2000:]}")
    env.pop("P3_FAULT_AFTER")
    resume = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                            text=True, timeout=300)
    if resume.returncode != 0:
        raise AssertionError(f"streaming resume failed:\n"
                             f"{resume.stderr[-2000:]}")
    if resumed.read_text() != plain_gfa.read_text():
        raise AssertionError("streaming resume: GFA differs from the "
                             "uncrashed run's")
    shutil.rmtree(ckpt)
    return slices, gpu


def multik_run(workdir: Path, genome: str, fasta: Path,
               pop_bubbles: bool = True, device: str = "cuda"):
    """Multi-k with simplification in a 2^33-bit filter through the CLI;
    one ``bloom_set_bits`` launch a round.  With bubbles popped the exact
    share is printed, not held (the reference's bubble rule, ROADMAP.md
    Queue 3).  Returns (launches, exact-substring share)."""
    what = "multi-k" if pop_bubbles else "multi-k without bubble popping"
    wall, launches, gfa, rounds = cli_run(
        workdir, fasta, ["--k-list", ",".join(map(str, MULTIK_K_LIST)),
                         "--clip-tips",
                         *(["--pop-bubbles"] if pop_bubbles else []), "-m",
                         str(MULTIK_FILTER_BITS), "--membership", "bloom"],
        device)
    log(f"{what}: cli wall {wall:.3f} s, bloom_set_bits launches "
        f"{launches}")
    for st in rounds:
        log(f"{what} k={st['k']}: solid nodes {st['solid_nodes']}, graph "
            f"nodes {st['graph_nodes']}, straights {st['straights']}, "
            f"junctions {st['junctions']}, N50 {st['straight_n50']}, "
            f"simplify drops {st['simplify_drops']}, closure rounds "
            f"{st['closure_rounds']}, elapsed {st['elapsed_s']:.3f} s")
        log(f"{what} k={st['k']}: stages (s) " + json.dumps(st["stages"]))
        log(f"{what} k={st['k']}: peak device memory per stage (bytes) "
            + json.dumps(st.get("peak_bytes", {})))
    if [st["k"] for st in rounds] != list(MULTIK_K_LIST):
        raise AssertionError(f"{what} ran rounds "
                             f"{[st['k'] for st in rounds]}")
    share = check_quality(gfa, genome, what, hold_exact=not pop_bubbles)[4]
    if device == "cuda" and launches != len(MULTIK_K_LIST):
        raise AssertionError(f"{what}: {launches} bloom_set_bits launches, "
                             f"not one a round")
    return launches, share


def log_spans(what: str, stats: dict) -> None:
    log(f"{what}: stages (s) " + json.dumps(stats["stages"]))
    log(f"{what}: peak device memory per stage (bytes) "
        + json.dumps(stats.get("peak_bytes", {})))


def ecoli_streaming_run(workdir: Path, genome: str, fasta: Path, chunks: int,
                        main_stats: dict, main_gfa: Path):
    """Phase 8's run through streaming, 2048 chunks a slice: the same GFA,
    one ``bloom_set_bits`` launch a slice.  Returns launches."""
    if main_stats["closure_rounds"] != 0 or \
            main_stats["graph_nodes"] != main_stats["solid_nodes"]:
        raise AssertionError("E. coli streaming: phase 8's Bloom closure "
                             "added nodes, which streaming never adds")
    wall, launches, gfa, (stats,) = cli_run(
        workdir, fasta, MAIN_ARGS + ["--streaming", "--slice-chunks",
                                     str(ECOLI_SLICE_CHUNKS)])
    slices = -(-chunks // ECOLI_SLICE_CHUNKS)
    log(f"E. coli streaming: cli wall {wall:.3f} s, {slices} slices, "
        f"bloom_set_bits launches {launches}, solid nodes "
        f"{stats['solid_nodes']}, straights {stats['straights']}, junctions "
        f"{stats['junctions']}, N50 {stats['straight_n50']}")
    log_spans("E. coli streaming", stats)
    if gfa.read_text() != main_gfa.read_text():
        raise AssertionError("E. coli streaming: GFA differs from phase 8's")
    if launches != slices:
        raise AssertionError(f"E. coli streaming: {launches} bloom_set_bits "
                             f"launches for {slices} slices")
    return launches


def sweep_run(genome: str, fasta: Path):
    """The threshold sweep on the main reads at k = 32 against the
    genome: ``n_solid`` must not rise with the threshold, the best F1 must
    be >= 0.95.  Returns the rows."""
    import torch
    from platanus3_tpu_torch.config import AssemblyConfig
    from platanus3_tpu_torch.sweep import solid_threshold_sweep
    torch.cuda.synchronize()
    t = time.time()
    rows = solid_threshold_sweep(
        str(fasta), AssemblyConfig(k=MAIN_K, log_path=None),
        SWEEP_THRESHOLDS, truth_genome=genome, device="cuda")
    torch.cuda.synchronize()
    log(f"sweep k={MAIN_K}: {time.time() - t:.3f} s for "
        f"{len(SWEEP_THRESHOLDS)} thresholds (one counting pass)")
    for row in rows:
        log("sweep: " + json.dumps(row))
    n_solid = [r["n_solid"] for r in rows]
    if any(a < b for a, b in zip(n_solid, n_solid[1:])):
        raise AssertionError(f"sweep: n_solid rises with the threshold "
                             f"{n_solid}")
    best = max(rows, key=lambda r: r["f1"])
    if best["f1"] < 0.95:
        raise AssertionError(f"sweep: best F1 {best['f1']} < 0.95")
    return rows


def chr21_run(workdir: Path):
    """The chromosome-sized streaming run (phase 12).  Returns
    (launches, stats)."""
    from platanus3_tpu_torch import sim
    t = time.time()
    genome = sim.random_genome(CHR21_GENOME_LEN, seed=0)
    reads = sim.simulate_reads(genome, coverage=12, read_len=8000, seed=1,
                               sub_rate=0.002)
    fasta = workdir / "chr21.fasta"
    with open(fasta, "w") as f:
        for i in range(0, len(reads), 4096):
            f.write("".join(f">r{j}\n{reads[j]}\n"
                            for j in range(i, min(i + 4096, len(reads)))))
    log(f"chr21: {len(reads)} reads, {sum(map(len, reads))} bases, "
        f"generated and written in {time.time() - t:.1f} s (host)")
    stride = 4096 - 25 + 1
    chunks = sum((len(r) - 25) // stride + 1 for r in reads if len(r) >= 25)
    slices = -(-chunks // CHR21_SLICE_CHUNKS)
    del reads
    wall, launches, gfa, (stats,) = cli_run(workdir, fasta, CHR21_ARGS)
    fasta.unlink()
    peak = max(stats.get("peak_bytes", {}).values(), default=0)
    log(f"chr21: cli wall {wall:.3f} s, {chunks} chunks in {slices} slices, "
        f"bloom_set_bits launches {launches}, solid nodes "
        f"{stats['solid_nodes']}, graph nodes {stats['graph_nodes']}, "
        f"straights {stats['straights']}, junctions {stats['junctions']}, "
        f"N50 {stats['straight_n50']}, peak device memory {peak} bytes")
    log_spans("chr21", stats)
    t = time.time()
    check_quality(gfa, genome, "chr21")
    log(f"chr21: quality check {time.time() - t:.1f} s (host)")
    if launches != slices:
        raise AssertionError(f"chr21: {launches} bloom_set_bits launches "
                             f"for {slices} slices")
    if peak >= DEVICE_BYTES_LIMIT:
        raise AssertionError(f"chr21: peak device memory {peak} bytes")
    return launches, stats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from platanus3_tpu_torch import kernels
    from platanus3_tpu_torch.pipeline import graph_cap

    gpu = gpu_line()
    log(f"gpu: {gpu}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.time()
    lib = kernels.load_library()
    log(f"build: {kernels.library_path().name} in {time.time() - t:.2f} s "
        f"({lib._name})")

    small = kernel_vs_plain(50_000, 40_000, 25, 16, 3, seed=1, reps=20)
    log(f"kernel small (50000 rows, k=25, 2^16 bits, 3 hashes): "
        f"max_abs_err {small[0]}, kernel {small[1]:.4f} ms, "
        f"plain {small[2]:.4f} ms")
    rows = graph_cap(GENOME_LEN)
    bloom_shapes = bloom_main_shapes(rows)
    bloom_shapes.append(bloom_slice_shape())
    sizes_err = bloom_sizes_check()
    log(f"kernel at 2^{BLOOM_CHECK_LOG2_BITS} bits (200000 rows, k=25, 4 "
        f"hashes, twice onto the same filter): bit-equal, inputs intact")

    t = time.time()
    par = parity_run()
    log(f"parity: GPU and CPU GFA identical ({len(par.gfa_lines)} lines, "
        f"{par.stats['solid_nodes']} solid -> {par.num_nodes} nodes after "
        f"{par.stats['closure_rounds']} closure rounds) in "
        f"{time.time() - t:.1f} s")
    t = time.time()
    mk = multik_parity_run()
    log(f"multi-k parity (k=32,64, tips and bubbles, 2^32 bits): GPU and "
        f"CPU GFA identical ({len(mk.gfa_lines)} lines, {mk.num_straights} "
        f"straights, {mk.stats['simplify_drops']} unitigs dropped in the "
        f"last round) in {time.time() - t:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        n_slices, st = streaming_parity_run(Path(tmp))
        log(f"streaming parity (8 chunks a slice, 2^18 bits): GPU and CPU "
            f"GFA identical ({len(st.gfa_lines)} lines, {st.num_nodes} "
            f"nodes), one bloom_set_bits launch for each of {n_slices} "
            f"slices; killed after spass2 (exit code 137) and resumed on "
            f"the card to the uncrashed GFA; in {time.time() - t:.1f} s")
    torch.cuda.empty_cache()

    genome, reads, arrays = main_reads()
    chunks = arrays["packed"].shape[0]
    oa_launches, oa_err, oa = oa_phase(arrays)
    bb_launches, bb_err, bb = blocked_phase(arrays)
    del arrays
    torch.cuda.empty_cache()
    if oa_launches < 1 or bb_launches < 1:
        raise AssertionError(f"a path never launched its kernel: "
                             f"oa_count_insert {oa_launches}, "
                             f"bloom_blocked_set_bits {bb_launches}")

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        fasta = work / "reads.fasta"
        with open(fasta, "w") as f:
            for i, r in enumerate(reads):
                f.write(f">r{i}\n{r}\n")
        del reads
        launches["main"], main_stats, main_gfa = main_run(work, genome,
                                                          fasta)
        torch.cuda.empty_cache()
        launches["main traced"], _ = traced_main_run(work, fasta)
        torch.cuda.empty_cache()
        launches["multi-k"], mk_share = multik_run(work, genome, fasta)
        torch.cuda.empty_cache()
        launches["multi-k without bubble popping"], wit_share = multik_run(
            work, genome, fasta, pop_bubbles=False)
        torch.cuda.empty_cache()
        launches["E. coli streaming"] = ecoli_streaming_run(
            work, genome, fasta, chunks, main_stats, main_gfa)
        torch.cuda.empty_cache()
        sweep_run(genome, fasta)
        torch.cuda.empty_cache()
    log(f"multi-k: exact-substring share {mk_share:.4f} with bubbles popped "
        f"by the JAX package's rule, {wit_share:.4f} without bubble popping; "
        f"the rule pops tandem arrays' loop arms, a known fault of the "
        f"reference (ROADMAP.md Queue 3)")
    del genome
    with tempfile.TemporaryDirectory() as tmp:
        launches["chr21 streaming"], _ = chr21_run(Path(tmp))
    torch.cuda.empty_cache()
    log("bloom_set_bits launches: " + json.dumps(launches))

    main_bloom = bloom_shapes[0]
    bloom_entry = kernel_entry(
        "bloom_set_bits", BLOOM_SOURCE,
        "platanus3_tpu/ops/bloom_pallas.py:53", sum(launches.values()),
        max([small[0], sizes_err] + [b["max_abs_err"] for b in bloom_shapes]),
        main_bloom["ms"], main_bloom["plain_ms"], main_bloom["bound_ms"])
    bloom_entry["shapes"] = [{key: b[key] for key in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
        for b in bloom_shapes]
    short = oa[SHORT_K]
    oa_entry = kernel_entry(
        "oa_count_insert", OA_SOURCE, "platanus3_tpu/ops/count_pallas.py:97",
        oa_launches, oa_err, short["ms"], short["plain_ms"],
        short["bound_ms"], short["unique_ms"])
    oa_entry["shapes"] = [
        {"shape": f"{m['rows']} rows, k={kk}, {m['slots']} slots",
         "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "library_ms": m["unique_ms"]} for kk, m in oa.items()]
    blocked = bb[BLOCKED_LOG2_BITS[0]]
    bb_entry = kernel_entry(
        "bloom_blocked_set_bits", BLOOM_SOURCE,
        "platanus3_tpu/ops/bloom_pallas.py:189", bb_launches, bb_err,
        blocked["ms"], blocked["plain_ms"], blocked["bound_ms"])
    bb_entry["shapes"] = [
        {"shape": (f"{m['rows']} rows, k={WIDE_BLOCKED_K}, 2^"
                   f"{BLOCKED_LOG2_BITS[0]} bits" if key == f"k{WIDE_BLOCKED_K}"
                   else f"{m['rows']} rows, k={MAIN_K}, 2^{key} bits"),
         "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "library_ms": None} for key, m in bb.items()]
    log(json.dumps({"kernels": [bloom_entry, oa_entry, bb_entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
