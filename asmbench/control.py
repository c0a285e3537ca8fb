"""The control of ``correct``: the plain reference with one guarantee
broken, put in the program's place and judged as a job's answer is.

The guarantee broken is exact k-mer identity: the control tells nodes
apart by a 32-bit fingerprint of their 2k-bit key (half of the int64 key
a k <= 32 node is held in), as a table of fingerprints would.  For each
seed it prints the numbers ``compare.checks`` gives the control beside
their limits, which have to fail:

    python3 -m asmbench.control --workload ecoli_k12.hifi20x \\
        --seeds 101 102 103

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from asmbench import compare, run, spec

__all__ = ["control_checks", "main"]


def control_checks(cell: spec.Cell, seed: int, device: str,
                   node_key_bits: int = 32) -> dict:
    """``compare.checks`` of the control's answer on ``seed``'s reads."""
    codes, offs = run.make_inputs(cell, seed)
    reference = cell.reference()
    params = cell.config["params"]
    ref = reference(codes, offs, params, device=device)
    ctl = reference(codes, offs, params, device=device,
                    node_key_bits=node_key_bits)
    return compare.checks([(ctl.gfa, ctl.solid_nodes)], ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="asmbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    failed_all = True
    for seed in args.seeds:
        t = time.perf_counter()
        checks = control_checks(cell, seed, "cuda")
        fails = any(c["value"] > c["limit"] for c in checks.values())
        failed_all &= fails
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "node_key_bits": 32,
                          "control_fails": fails, "check": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
