"""Command-line interface.

Flag-compatible with the reference binary (``Options::Parse``, reference
``src/Options.cpp:23-48``: ``-i`` readfile, ``-m`` filter bits, ``-k``
k-mer length, ``-t`` threads) plus the knobs the reference hardcodes
(SURVEY.md §5 config row) and the new framework's extensions (multi-k,
simplification, mesh).

Usage (matches ``ShowUsage``, ``src/ShowInfo.cpp:9``):
    python -m platanus3_tpu_torch.cli -i {readfile} -k {kmersize} -t {threads}

Port of ``platanus3_tpu/cli.py`` with the same flags plus ``--device``;
``--k-list`` with several k runs ``graph/multik.assemble_multik`` (and
then, as in the JAX package, ``--streaming`` is not applied), else
``--streaming`` runs ``streaming.assemble_streaming``.  ``--mesh`` shards
over the ranks a launcher started (``parallel/sharded.py``), e.g. four on
the CPU:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m platanus3_tpu_torch.cli --mesh --device cpu -i reads.fasta ...

Without a launcher's environment ``--mesh`` is a world of one rank.  Only
rank 0 writes the GFA, the log and the FASTA, and prints.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="platanus3-tpu-torch",
        description="de Bruijn assembler (platanus3-capable, "
                    "PyTorch + CUDA port of platanus3-tpu).")
    p.add_argument("-i", dest="readfile", required=False,
                   help="input reads (.fasta/.fastq)")
    p.add_argument("-m", dest="filter_bits", type=int, default=0,
                   help="Bloom filter size in bits (0 = auto)")
    p.add_argument("-k", dest="k", type=int, default=25,
                   help="k-mer length (default 25)")
    p.add_argument("-t", dest="threads", type=int, default=8,
                   help="accepted for compatibility; PyTorch manages threads")
    p.add_argument("--short-k", type=int, default=21)
    p.add_argument("--cov-threshold", type=int, default=2)
    p.add_argument("--filter-policy", choices=["safe", "reference"],
                   default="safe",
                   help="auto Bloom sizing: 'safe' sizes for all k-mers; "
                        "'reference' reproduces the reference formula "
                        "(known to saturate on clean data)")
    p.add_argument("--chunk-len", type=int, default=1024)
    p.add_argument("--k-list", type=str, default="",
                   help="comma-separated multi-k schedule, e.g. 32,64,128")
    p.add_argument("--clip-tips", action="store_true")
    p.add_argument("--tip-max-len", type=int, default=0,
                   help="tip length cutoff (0 = auto, 2k)")
    p.add_argument("--tip-cov-ratio", type=float, default=0.0,
                   help="also clip tips coverage-dominated by this ratio")
    p.add_argument("--pop-bubbles", action="store_true")
    p.add_argument("--bubble-len-ratio", type=float, default=1.2)
    p.add_argument("--simplify-rounds", type=int, default=3,
                   help="simplification rounds (0 = to fixpoint)")
    p.add_argument("--no-seed-restrict", action="store_true",
                   help="emit all components, not only seed-reachable ones")
    p.add_argument("--membership", choices=["exact", "bloom"],
                   default="exact",
                   help="graph adjacency oracle: 'exact' (default) probes "
                        "the exact solid-k-mer table, no false positives; "
                        "'bloom' probes a Bloom filter like the reference "
                        "(FPs included)")
    p.add_argument("--exact-membership", action="store_true",
                   help=argparse.SUPPRESS)  # legacy alias of the default
    p.add_argument("--mesh", action="store_true",
                   help="shard the k-mer tables over the ranks of a "
                        "torch.distributed launch (torch.distributed.run)")
    p.add_argument("--streaming", action="store_true",
                   help="bounded-memory mode for read sets larger than "
                        "device HBM (two-pass counting)")
    p.add_argument("--slice-chunks", type=int, default=2048,
                   help="chunks resident per device step in --streaming")
    p.add_argument("--short-cap-log2", type=int, default=0,
                   help="streaming: log2 capacity for distinct short "
                        "k-mers (0 = auto)")
    p.add_argument("--node-cap-log2", type=int, default=0,
                   help="streaming: log2 capacity for solid nodes "
                        "(0 = auto)")
    p.add_argument("-o", "--output", default="./de_bruijn_graph.gfa")
    p.add_argument("--fasta-out", default="",
                   help="also export assembled contigs (unitigs) as FASTA")
    p.add_argument("--min-contig", type=int, default=0,
                   help="minimum contig length for --fasta-out")
    p.add_argument("--log", default="./platanus3.log")
    p.add_argument("--checkpoint-dir", default="",
                   help="directory for stage checkpoints (resume support)")
    p.add_argument("--trace-dir", default="",
                   help="write a torch.profiler Chrome trace of the run "
                        "here (trace.json; open with Perfetto)")
    p.add_argument("--profile-stages", action="store_true",
                   help="barrier at stage boundaries so the logged "
                        "per-stage breakdown is exact; on a card also "
                        "log each stage's peak memory and count host "
                        "syncs a stage")
    p.add_argument("--echo-log", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to assemble on (default cuda; "
                        "'cpu' runs the plain PyTorch versions of the "
                        "kernels)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.readfile:
        print("Usage: python -m platanus3_tpu_torch.cli -i {readfile} "
              "-k {kmersize} -t {numthread}")
        return 0

    from platanus3_tpu_torch.config import AssemblyConfig

    k_list = tuple(int(x) for x in args.k_list.split(",") if x)
    cfg = AssemblyConfig(
        k=k_list[0] if k_list else args.k,
        filter_bits=args.filter_bits,
        threads=args.threads,
        short_k=args.short_k,
        cov_threshold=args.cov_threshold,
        filter_policy=args.filter_policy,
        chunk_len=args.chunk_len,
        k_list=k_list,
        clip_tips=args.clip_tips,
        tip_max_len=args.tip_max_len,
        tip_cov_ratio=args.tip_cov_ratio,
        pop_bubbles=args.pop_bubbles,
        bubble_len_ratio=args.bubble_len_ratio,
        simplify_rounds=args.simplify_rounds,
        restrict_to_seeds=not args.no_seed_restrict,
        use_exact_membership=(args.membership == "exact"
                              or args.exact_membership),
        gfa_path=args.output,
        log_path=args.log,
        checkpoint_dir=args.checkpoint_dir,
        trace_dir=args.trace_dir,
        profile_stages=args.profile_stages,
    )
    mesh = None
    if args.mesh:
        from platanus3_tpu_torch.parallel import sharded
        mesh = sharded.make_mesh(args.device)
    try:
        res = _run(args, cfg, k_list, mesh)
    finally:
        if mesh is not None and mesh.size > 1:
            import torch.distributed as dist
            dist.destroy_process_group()
    if mesh is not None and not mesh.is_root:
        return 0
    print(f"wrote {cfg.gfa_path}: {res.num_straights} straights, "
          f"{res.num_junctions} junctions")
    if args.fasta_out:
        from platanus3_tpu_torch.io import gfa as gfa_mod
        n = gfa_mod.write_contig_fasta(args.fasta_out, res.gfa_lines,
                                       min_len=args.min_contig)
        print(f"wrote {args.fasta_out}: {n} contigs")
    return 0


def _run(args, cfg, k_list, mesh):
    from platanus3_tpu_torch.pipeline import assemble
    from platanus3_tpu_torch.utils.logging import PipelineLog
    log = PipelineLog(cfg.log_path, echo=args.echo_log)
    if len(k_list) > 1:
        from platanus3_tpu_torch.graph.multik import assemble_multik
        return assemble_multik(args.readfile, cfg, log=log, mesh=mesh,
                               device=args.device)
    if args.streaming:
        from platanus3_tpu_torch.streaming import assemble_streaming
        return assemble_streaming(
            args.readfile, cfg, log=log,
            short_cap=(1 << args.short_cap_log2) if args.short_cap_log2
            else 0,
            node_cap=(1 << args.node_cap_log2) if args.node_cap_log2 else 0,
            slice_chunks=args.slice_chunks, mesh=mesh, device=args.device)
    return assemble(args.readfile, cfg, log=log, mesh=mesh,
                    device=args.device)


if __name__ == "__main__":
    sys.exit(main())
