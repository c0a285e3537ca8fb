#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (platanus3_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit on failure:

1. device: no CUDA device, no run; prints the card's name and power limit
   as ``nvidia-smi`` gives them;
2. build: compiles the CUDA kernels from ``platanus3_tpu_torch/csrc``;
3. kernel vs plain: ``bloom_set_bits`` (through ``ops.bloom.bloom_add``)
   against the plain PyTorch build on the card, at a small shape and at
   the main run's shape; the words must be bit-equal; times from CUDA
   events;
4. CPU/GPU parity: a 20 kb genome at 25x in Bloom mode with a filter small
   enough that the false-positive closure runs; the GFA line lists from
   the card and from the CPU (plain versions) must be identical;
5. main run: BASELINE config 1 -- a generated genome of E. coli K-12
   MG1655's length and GC (4,641,652 bp, 50.8 %; NCBI NC_000913.3), 20x of
   10 kb reads with 0.1 % substitutions, through the port's ``cli.main``
   with ``-k 32 -m 1073741824 --membership bloom``; checks the launch count
   and that the straights cover >= 0.9 of the genome, >= 0.9 of their
   bases as exact genome substrings.

The second-to-last line is the kernels' JSON, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

GENOME_LEN = 4_641_652        # E. coli K-12 MG1655, NC_000913.3
GENOME_GC = 0.508
MAIN_FILTER_BITS = 1 << 30
MAIN_HASHES = 10
KERNEL_SOURCE = "platanus3_tpu_torch/csrc/bloom.cu"
KERNEL_REPLACES = "platanus3_tpu/ops/bloom_pallas.py:53"


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


def kernel_vs_plain(rows, valid_rows, k, log2_bits, hashes, seed, reps):
    """Kernel and plain build on the same inputs: (max_abs_err, ms,
    plain_ms)."""
    import torch
    from platanus3_tpu_torch.ops import bloom
    dev = torch.device("cuda")
    canon = random_canon(rows, k, seed, dev)
    mask = torch.arange(rows, device=dev) < valid_rows
    empty = bloom.make_bloom(1 << log2_bits, hashes, device=dev)
    got = bloom.bloom_add(empty, canon, k, mask=mask)
    want = bloom.bloom_add_plain(empty, canon, k, mask=mask)
    torch.cuda.synchronize()
    err = int((got.bits.long() - want.bits.long()).abs().max())
    if not torch.equal(got.bits, want.bits) or err != 0:
        raise AssertionError(f"bloom_set_bits differs from the plain build "
                             f"at rows={rows} k={k} 2^{log2_bits} bits: "
                             f"max_abs_err={err}")
    if int(got.bits.ne(0).sum()) == 0:
        raise AssertionError("kernel set no bit")
    ms = cuda_time_ms(lambda: bloom.bloom_add(empty, canon, k, mask=mask),
                      reps)
    plain_ms = cuda_time_ms(
        lambda: bloom.bloom_add_plain(empty, canon, k, mask=mask), reps)
    return err, ms, plain_ms


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


def n50(lengths):
    total, acc = sum(lengths), 0
    for x in sorted(lengths, reverse=True):
        acc += x
        if 2 * acc >= total:
            return x
    return 0


def main_run(workdir: Path, genome_len: int = GENOME_LEN,
             device: str = "cuda"):
    import torch
    from platanus3_tpu_torch import cli, sim
    from platanus3_tpu_torch.ops import bloom

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.time()
    genome = sim.realistic_genome(genome_len, seed=1, gc=GENOME_GC)
    reads = sim.simulate_reads(genome, coverage=20, read_len=10_000, seed=2,
                               sub_rate=0.001)
    fasta = workdir / "reads.fasta"
    with open(fasta, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    log(f"main: {len(reads)} reads, {sum(map(len, reads))} bases "
        f"generated in {time.time() - t0:.1f} s (host)")

    gfa, run_log = workdir / "out.gfa", workdir / "run.log"
    bloom.bloom_add.kernel_launches = 0
    sync()
    t1 = time.time()
    rc = cli.main(["-i", str(fasta), "-k", "32", "-m",
                   str(MAIN_FILTER_BITS), "--membership", "bloom",
                   "-o", str(gfa), "--log", str(run_log),
                   "--profile-stages", "--device", device])
    sync()
    wall = time.time() - t1
    launches = bloom.bloom_add.kernel_launches
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")

    stats = None
    for line in run_log.read_text().splitlines():
        if "] stats {" in line:
            stats = json.loads(line.split("] stats ", 1)[1])
    if stats is None:
        raise AssertionError("no stats line in the run log")
    lines = gfa.read_text().splitlines()
    straights = [ln.split("\t")[2] for ln in lines
                 if ln.startswith("S\tStraight")]
    n_jun = sum(1 for ln in lines if ln.startswith("S\tJunction"))
    lengths = [len(s) for s in straights]
    total = sum(lengths)
    rc_genome = sim.revcomp(genome)
    exact = sum(len(s) for s in straights if s in genome or s in rc_genome)

    log(f"main: cli wall {wall:.3f} s; stages (s): "
        + json.dumps(stats["stages"]))
    log("main: peak device memory per stage (bytes): "
        + json.dumps(stats.get("peak_bytes", {})))
    log(f"main: solid nodes {stats['solid_nodes']}, graph nodes "
        f"{stats['graph_nodes']}, straights {len(straights)}, junctions "
        f"{n_jun}, closure rounds {stats['closure_rounds']}")
    log(f"main: straight length sum {total} "
        f"({total / genome_len:.4f} of the genome), N50 {n50(lengths)}, "
        f"exact-substring share {exact / max(total, 1):.4f}")
    log(f"main: bloom_set_bits launches {launches}")
    if device == "cuda" and launches < 1:
        raise AssertionError("the main run never launched bloom_set_bits")
    if total < 0.9 * genome_len:
        raise AssertionError(f"straights cover {total} < 0.9 x {genome_len}")
    if exact < 0.9 * total:
        raise AssertionError(f"only {exact} of {total} straight bases are "
                             f"exact genome substrings")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from platanus3_tpu_torch import kernels
    from platanus3_tpu_torch.pipeline import _graph_cap

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
    rows = _graph_cap(GENOME_LEN)
    big = kernel_vs_plain(rows, GENOME_LEN, 32, 30, MAIN_HASHES, seed=2,
                          reps=10)
    log(f"kernel main shape ({rows} rows, {GENOME_LEN} masked in, k=32, "
        f"2^30 bits, {MAIN_HASHES} hashes): max_abs_err {big[0]}, "
        f"kernel {big[1]:.4f} ms, plain {big[2]:.4f} ms")

    t = time.time()
    par = parity_run()
    log(f"parity: GPU and CPU GFA identical ({len(par.gfa_lines)} lines, "
        f"{par.stats['solid_nodes']} solid -> {par.num_nodes} nodes after "
        f"{par.stats['closure_rounds']} closure rounds) in "
        f"{time.time() - t:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        launches = main_run(Path(tmp))

    log(json.dumps({"kernels": [{
        "name": "bloom_set_bits", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(small[0], big[0]), "ms": big[1],
        "plain_ms": big[2]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
