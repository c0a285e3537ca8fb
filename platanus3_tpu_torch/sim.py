"""Synthetic read simulation: random genomes and error-prone long reads.

Supports BASELINE configs 2-4 (error-prone PacBio/ONT-like read sets,
tip/bubble-inducing error profiles, multi-k runs).  The reference repo has
no simulator or test data; its behavior on error-prone reads is defined by
the solidity filter (window-min of exact short-k counts >= threshold,
``src/MakeBloomFilter.cpp:24-89``) which this module exists to exercise.

Error model (vectorized numpy, per read):

  1. substitutions: each base flips to one of the OTHER three bases with
     probability ``sub_rate`` (dominant ONT error mode);
  2. deletions: each base is dropped with probability ``del_rate``;
  3. insertions: after each surviving base, a uniform random base is
     inserted with probability ``ins_rate`` (dominant PacBio CLR mode).

Half of the reads are reverse-complemented (real libraries sample both
strands; exercises canonicalization everywhere).

Port of ``platanus3_tpu/sim.py`` (numpy; the same seed gives the same
genomes and reads).  ``genome_kmer_table``, the truth set of the
threshold sweep, runs on a torch device with the pipeline's ops.
"""

from __future__ import annotations

import numpy as np

__all__ = ["random_genome", "simulate_reads", "mutate_genome",
           "plant_repeats", "gc_skewed_genome", "plant_homopolymers",
           "plant_tandem_repeats", "realistic_genome", "genome_kmer_table"]

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = str.maketrans("ACGT", "TGCA")


def random_genome(length: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    return _codes_to_str(rng.integers(0, 4, size=length, dtype=np.uint8))


def _codes_to_str(codes: np.ndarray) -> str:
    return _BASES[codes].tobytes().decode()


def _str_to_codes(s: str) -> np.ndarray:
    b = np.frombuffer(s.encode(), dtype=np.uint8)
    codes = np.zeros_like(b)
    codes[b == ord("C")] = 1
    codes[b == ord("G")] = 2
    codes[b == ord("T")] = 3
    return codes


def revcomp(s: str) -> str:
    return s[::-1].translate(_COMP)


def _apply_errors(codes: np.ndarray, rng, sub_rate: float, ins_rate: float,
                  del_rate: float) -> np.ndarray:
    n = codes.shape[0]
    if sub_rate > 0:
        sub = rng.random(n) < sub_rate
        # a DIFFERENT base, uniformly among the other three
        codes = np.where(
            sub, (codes + rng.integers(1, 4, size=n)) % 4, codes
        ).astype(np.uint8)
    if del_rate > 0:
        codes = codes[rng.random(n) >= del_rate]
        n = codes.shape[0]
    if ins_rate > 0 and n > 0:
        reps = 1 + (rng.random(n) < ins_rate).astype(np.int64)
        out = np.repeat(codes, reps)
        # positions where an inserted copy landed: the second of each pair
        ins_at = np.cumsum(reps)[reps > 1] - 1
        out[ins_at] = rng.integers(0, 4, size=ins_at.shape[0], dtype=np.uint8)
        codes = out
    return codes


def simulate_reads(genome: str, coverage: float, read_len: int,
                   seed: int = 0, sub_rate: float = 0.0,
                   ins_rate: float = 0.0, del_rate: float = 0.0,
                   circular: bool = False) -> list:
    """Sample ``coverage``× reads of ``read_len`` bases with errors.

    Linear genomes are sampled uniformly over valid start positions (read
    ends clamp at the genome end); circular genomes wrap around.
    """
    g = _str_to_codes(genome)
    n_reads = max(1, int(len(genome) * coverage / read_len))
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n_reads):
        if circular:
            s = int(rng.integers(0, len(g)))
            idx = (s + np.arange(read_len)) % len(g)
            codes = g[idx]
        else:
            s = int(rng.integers(0, max(1, len(g) - read_len + 1)))
            codes = g[s : s + read_len]
        codes = _apply_errors(codes, rng, sub_rate, ins_rate, del_rate)
        seq = _codes_to_str(codes)
        if rng.random() < 0.5:
            seq = revcomp(seq)
        reads.append(seq)
    return reads


def mutate_genome(genome: str, n_snps: int, seed: int = 0,
                  min_gap: int = 0) -> str:
    """Introduce ``n_snps`` substitutions (a haplotype / bubble generator).

    With ``min_gap`` > 0 the SNP positions are at least that far apart, so
    each SNP produces an isolated bubble at k < min_gap.
    """
    g = _str_to_codes(genome)
    rng = np.random.default_rng(seed)
    if min_gap <= 0:
        pos = rng.choice(len(g), size=n_snps, replace=False)
    else:
        cand = np.arange(min_gap, len(g) - min_gap, min_gap)
        pos = rng.choice(cand, size=min(n_snps, cand.shape[0]),
                         replace=False)
    g[pos] = (g[pos] + rng.integers(1, 4, size=pos.shape[0])) % 4
    return _codes_to_str(g)


def plant_repeats(genome: str, repeat_len: int, n_copies: int,
                  seed: int = 0, min_gap: int = 0) -> str:
    """Overwrite ``n_copies`` loci with the SAME random repeat element.

    At k <= repeat_len the copies collapse into one tangle of junctions;
    k > repeat_len (or a multi-k schedule ending there) resolves them --
    the scenario BASELINE config 4's multi-k iteration exists for.
    """
    g = _str_to_codes(genome)
    rng = np.random.default_rng(seed)
    rep = rng.integers(0, 4, size=repeat_len, dtype=np.uint8)
    gap = max(min_gap, 2 * repeat_len)
    cand = np.arange(gap, len(g) - repeat_len - gap, gap)
    pos = rng.choice(cand, size=min(n_copies, cand.shape[0]), replace=False)
    for p in pos:
        g[p : p + repeat_len] = rep
    return _codes_to_str(g)


def gc_skewed_genome(length: int, gc: float = 0.6, seed: int = 0) -> str:
    """Random genome with non-uniform base composition (GC fraction
    ``gc``).  Uniform composition (random_genome) has no hash/Bloom load
    skew; real genomes do (VERDICT r3 weak #4)."""
    rng = np.random.default_rng(seed)
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return _codes_to_str(
        rng.choice(4, size=length, p=p).astype(np.uint8))


def plant_homopolymers(genome: str, n_runs: int, min_len: int = 8,
                       max_len: int = 30, seed: int = 0) -> str:
    """Overwrite ``n_runs`` loci with single-base runs (AAAA.../TTTT...).

    Homopolymer runs produce low-complexity canonical k-mers, window-min
    ties, and (for A/T runs) palindrome-dense neighborhoods -- the
    structures uniform-random genomes never contain."""
    g = _str_to_codes(genome)
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n_runs)
    for run_len in lens:
        p = int(rng.integers(0, max(1, len(g) - run_len)))
        g[p:p + run_len] = rng.integers(0, 4)
    return _codes_to_str(g)


def plant_tandem_repeats(genome: str, n_loci: int, unit_min: int = 2,
                         unit_max: int = 12, copies_min: int = 4,
                         copies_max: int = 40, seed: int = 0) -> str:
    """Overwrite ``n_loci`` loci with tandem arrays (unit^n).  Each locus
    gets its OWN random unit (2-12 bp microsatellites up to minisatellite
    scale), so the graph gains short local cycles and tangles rather than
    the genome-wide junction pairs ``plant_repeats`` creates.  A 2 bp
    AT-like unit yields reverse-complement-palindromic tracts -- the
    canonicalization stress case."""
    g = _str_to_codes(genome)
    rng = np.random.default_rng(seed)
    for _ in range(n_loci):
        unit_len = int(rng.integers(unit_min, unit_max + 1))
        copies = int(rng.integers(copies_min, copies_max + 1))
        tract = np.tile(rng.integers(0, 4, size=unit_len, dtype=np.uint8),
                        copies)
        p = int(rng.integers(0, max(1, len(g) - tract.shape[0])))
        g[p:p + tract.shape[0]] = tract
    return _codes_to_str(g)


def realistic_genome(length: int, seed: int = 0, gc: float = 0.6,
                     homopolymers_per_mb: int = 300,
                     tandems_per_mb: int = 150,
                     dispersed_repeat_len: int = 200,
                     dispersed_per_mb: int = 100) -> str:
    """Compositor for a structurally realistic genome (VERDICT r3 item 6):
    GC-skewed composition + homopolymer runs + tandem/low-complexity
    tracts + dispersed repeat copies.  These are the features that stress
    canonical-k-mer pipelines (palindrome density, window-min ties, Bloom
    and hash-prefix load skew) on real E. coli / yeast / chr21 data."""
    mb = length / 1e6
    g = gc_skewed_genome(length, gc=gc, seed=seed)
    g = plant_homopolymers(g, max(1, int(homopolymers_per_mb * mb)),
                           seed=seed + 1)
    g = plant_tandem_repeats(g, max(1, int(tandems_per_mb * mb)),
                             seed=seed + 2)
    if dispersed_per_mb > 0 and length > 4 * dispersed_repeat_len:
        g = plant_repeats(g, dispersed_repeat_len,
                          max(1, int(dispersed_per_mb * mb)), seed=seed + 3)
    return g


def genome_kmer_table(genome: str, k: int, chunk_len: int = 4096,
                      device="cuda"):
    """Exact canonical k-mer count table of a genome string on ``device``
    (the TRUTH set for the precision and recall of the solidity filter),
    with the pipeline's ops.  Raises on ``cuda`` without a card."""
    import torch
    from platanus3_tpu_torch import pipeline
    from platanus3_tpu_torch.io import reads as reads_mod
    from platanus3_tpu_torch.ops import count as count_mod
    from platanus3_tpu_torch.ops import kmer as kmer_mod
    from platanus3_tpu_torch.ops import solid as solid_mod

    device = pipeline.check_device(device, "genome_kmer_table")

    def dev(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)

    batch = reads_mod.reads_from_strings([genome], k, chunk_len)
    bases = kmer_mod.unpack_bases(dev(batch.packed))
    fw, valid = kmer_mod.extract_kmers(bases, dev(batch.valid_len), k)
    canon, _ = kmer_mod.canonical(fw, k)
    owned = solid_mod.owned_mask(dev(batch.start), dev(batch.read_len),
                                 batch.stride, fw.shape[1], k, k) & valid
    l = canon.shape[-1]
    return count_mod.count_kmers(canon.reshape(-1, l), owned.reshape(-1))
