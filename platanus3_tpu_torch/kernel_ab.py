"""A/B of the hand-written kernels and the main run between two trees.

    python -m platanus3_tpu_torch.kernel_ab OTHER_TREE [--json PATH]

OTHER_TREE is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  The two trees run in turns, other, this, this, other, each turn
in fresh processes on one CUDA card:

- kernels: ``bloom_set_bits`` (through ``ops.bloom.bloom_add``) and
  ``bloom_blocked_set_bits`` at 2^30 and 2^33 bits (through
  ``ops.bloom_blocked.build_blocked_bloom``) at the main run's shape,
  and ``oa_count_insert`` (through
  ``ops.count_oa.count_kmers_oa``) on the main run's short (k = 21) and
  k = 32 positions, each timed by CUDA events with ``chip_smoke.py``'s
  helpers of that tree;
- the main run: the port's CLI on ``chip_smoke.py``'s main reads with
  ``-k 32 -m 1073741824 --membership bloom --profile-stages``; its
  ``elapsed_s`` and a digest of the GFA.

Prints one JSON line per turn, then a summary line; fails if the GFA of
any turn differs from the first one's.  Needs the card: there is no CPU
mode.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parents[1]

# Run in a tree's root; uses only what both trees have.
_KERNELS = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from platanus3_tpu_torch.ops import bloom, bloom_blocked, count_oa, kmer, solid
from platanus3_tpu_torch import pipeline
dev = torch.device("cuda")
# Older trees name the node capacity ``_graph_cap``.
graph_cap = getattr(pipeline, "graph_cap", None) or pipeline._graph_cap
rows = graph_cap(cs.GENOME_LEN)
canon = cs.random_canon(rows, cs.MAIN_K, 2, dev)
mask = torch.arange(rows, device=dev) < cs.GENOME_LEN
empty = bloom.make_bloom(cs.MAIN_FILTER_BITS, cs.MAIN_HASHES, device=dev)
out = {"bloom_set_bits_ms": cs.cuda_time_ms(
    lambda: bloom.bloom_add(empty, canon, cs.MAIN_K, mask=mask), 20)}
for lb in cs.BLOCKED_LOG2_BITS:
    out[f"bloom_blocked_set_bits_2^{lb}_ms"] = cs.cuda_time_ms(
        lambda: bloom_blocked.build_blocked_bloom(
            canon, cs.MAIN_K, mask, lb, cs.MAIN_HASHES), 20)
del canon, mask
_, _, arrays = cs.main_reads()
bases = kmer.unpack_bases(arrays["packed"])
for kk in (cs.SHORT_K, cs.MAIN_K):
    c, _, owned = solid.short_kmer_positions(
        bases, arrays["valid_len"], arrays["start"], arrays["read_len"],
        arrays["stride"], kk, cs.MAIN_K)
    c = c.reshape(-1, c.shape[-1])
    contrib = owned.reshape(-1)
    del owned
    out[f"oa_count_insert_k{kk}_ms"] = cs.cuda_time_ms(
        lambda: count_oa.count_kmers_oa(c, contrib, kk), 10)
    del c, contrib
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def _run(cmd, cwd: Path) -> str:
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[:3]} in {cwd} failed ({proc.returncode}):"
                           f"\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def turn(tree: Path, fasta: Path, work: Path) -> dict:
    """One turn of one tree: kernel times, then the CLI main run."""
    res = json.loads(_run([sys.executable, "-c", _KERNELS],
                          tree).strip().splitlines()[-1])
    gfa, run_log = work / "out.gfa", work / "run.log"
    _run([sys.executable, "-m", "platanus3_tpu_torch.cli", "-i", str(fasta),
          "-k", "32", "-m", "1073741824", "--membership", "bloom",
          "--profile-stages", "-o", str(gfa), "--log", str(run_log)], tree)
    for line in run_log.read_text().splitlines():
        if "] stats {" in line:
            stats = json.loads(line.split("] stats ", 1)[1])
    res["cli_elapsed_s"] = stats["elapsed_s"]
    res["stages_s"] = stats["stages"]
    res["gfa_sha256"] = hashlib.sha256(gfa.read_bytes()).hexdigest()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other tree's root")
    ap.add_argument("--json", type=Path, help="also write the turns here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(THIS_TREE))
    import chip_smoke as cs

    trees = {"other": args.other.resolve(), "this": THIS_TREE}
    print(f"gpu: {cs.gpu_line()}", flush=True)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        _, reads, _ = cs.main_reads(device="cpu")
        fasta = work / "reads.fasta"
        fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
        for name in ("other", "this", "this", "other"):
            res = {"tree": name, **turn(trees[name], fasta, work)}
            print(json.dumps(res), flush=True)
            turns.append(res)
    same = len({t["gfa_sha256"] for t in turns}) == 1
    print(json.dumps({"gfa_identical": same}), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(turns, indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
