"""Graph simplification and multi-k iteration in the port against the JAX
package: the GFA line for line, tolerance "exact".

The inputs are those of ``tests/test_simplify_multik.py``: a short spur
(tip), a long spur clipped by the coverage rule, nested spurs that need a
second round, a bubble, and multi-k at (25, 63) and (32, 48).
"""

import numpy as np
import pytest

from platanus3_tpu import sim as jsim
from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.graph.multik import assemble_multik as j_multik
from platanus3_tpu.pipeline import assemble as j_assemble
from platanus3_tpu_torch import cli as t_cli
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.graph.multik import assemble_multik as t_multik
from platanus3_tpu_torch.pipeline import assemble as t_assemble

BASES = "ACGT"


def rand_genome(n, rng):
    return "".join(rng.choice(list(BASES), size=n))


def tiled_reads(genome, read_len, step):
    return [genome[s:s + read_len]
            for s in range(0, len(genome) - read_len + 1, step)]


def tip_reads():
    rng = np.random.default_rng(41)
    genome = rand_genome(1200, rng)
    spur = genome[575:600] + rand_genome(15, rng)
    return tiled_reads(genome, 200, 40) + [spur, spur]


def weak_tip_reads():
    rng = np.random.default_rng(53)
    genome = rand_genome(1200, rng)
    spur = genome[575:600] + rand_genome(70, rng)
    return tiled_reads(genome, 200, 40) + [spur, spur]


def nested_tip_reads():
    rng = np.random.default_rng(59)
    genome = rand_genome(1200, rng)
    stem = genome[575:600] + rand_genome(20, rng)
    arm1 = stem[-25:] + rand_genome(20, rng)
    arm2 = stem[-25:] + rand_genome(20, rng)
    return tiled_reads(genome, 200, 40) + [stem, stem, arm1, arm1, arm2,
                                           arm2]


def bubble_reads():
    rng = np.random.default_rng(43)
    left, right = rand_genome(600, rng), rand_genome(600, rng)
    mid_hi, mid_lo = rand_genome(60, rng), rand_genome(60, rng)
    return (tiled_reads(left + mid_hi + right, 200, 30)
            + tiled_reads(left + mid_lo + right, 200, 60))


def repeat_reads():
    rng = np.random.default_rng(47)
    rep = rand_genome(40, rng)
    genome = (rand_genome(400, rng) + rep + rand_genome(400, rng) + rep
              + rand_genome(400, rng))
    return tiled_reads(genome, 220, 40)


def noisy_reads():
    genome = jsim.random_genome(4000, seed=71)
    return jsim.simulate_reads(genome, coverage=18, read_len=400, seed=72,
                               sub_rate=0.003)


SIMPLIFY = {
    "tip": (tip_reads, dict(clip_tips=True), 1),
    "weak_tip": (weak_tip_reads, dict(clip_tips=True, tip_cov_ratio=2.0), 1),
    "one_round": (nested_tip_reads, dict(clip_tips=True, simplify_rounds=1),
                  3),
    "fixpoint": (nested_tip_reads, dict(clip_tips=True, simplify_rounds=0),
                 1),
    "bubble": (bubble_reads, dict(pop_bubbles=True), None),
}


@pytest.mark.parametrize("name", sorted(SIMPLIFY))
def test_simplify_gfa_identical(name):
    make, kw, straights = SIMPLIFY[name]
    reads = make()
    cfg = dict(k=25, chunk_len=512, log_path=None, **kw)
    j = j_assemble(reads, JConfig(**cfg), write_output=False)
    t = t_assemble(reads, TConfig(**cfg), write_output=False, device="cpu")
    assert t.gfa_lines == j.gfa_lines
    assert t.straight_seqs == j.straight_seqs
    assert t.stats["simplify_drops"] >= 1
    if straights is not None:
        assert t.num_straights == straights
    stages = t.stats["stages"]
    parts = [stages[f"simplify.{p}"] for p in ("to_host", "decide", "stage2",
                                                "stage3")]
    assert sum(parts) <= stages["simplify"]


MULTIK = {
    "25_63": (repeat_reads, dict(k=25, k_list=(25, 63), chunk_len=512)),
    "32_48": (noisy_reads, dict(k=32, k_list=(32, 48), cov_threshold=3,
                                chunk_len=256)),
}


@pytest.mark.parametrize("name", sorted(MULTIK))
def test_multik_gfa_identical(name):
    make, kw = MULTIK[name]
    reads = make()
    j = j_multik(reads, JConfig(log_path=None, **kw), write_output=False)
    t = t_multik(reads, TConfig(log_path=None, **kw), write_output=False,
                 device="cpu")
    assert t.gfa_lines == j.gfa_lines
    assert t.num_straights == j.num_straights >= 1


def test_cli_k_list_with_simplification(tmp_path):
    """``--k-list`` with several k and ``--clip-tips --pop-bubbles``
    through the port's CLI, against the JAX package's multi-k run."""
    reads = noisy_reads()
    fasta = tmp_path / "reads.fasta"
    fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    out, log = tmp_path / "out.gfa", tmp_path / "run.log"
    rc = t_cli.main(["-i", str(fasta), "--k-list", "32,48", "--clip-tips",
                     "--pop-bubbles", "--cov-threshold", "3",
                     "--chunk-len", "256", "-o", str(out), "--log", str(log),
                     "--device", "cpu"])
    assert rc == 0
    j = j_multik(str(fasta), JConfig(k=32, k_list=(32, 48), clip_tips=True,
                                     pop_bubbles=True, cov_threshold=3,
                                     chunk_len=256, log_path=None),
                 write_output=False)
    assert out.read_text().splitlines() == j.gfa_lines
    text = log.read_text()
    assert "multi-k round k=48" in text and "extra-solid merge" in text


def tandem_reads():
    """A 132 bp tandem array (unit 11) between unique flanks: at k = 25 the
    array is a loop X -> Y -> X in the graph."""
    rng = np.random.default_rng(67)
    left = rand_genome(600, rng)
    genome = left + rand_genome(11, rng) * 12 + rand_genome(600, rng)
    return genome, tiled_reads(genome, 300, 20)


def test_tandem_loop_is_not_a_bubble():
    """A tandem array's loop is not a bubble, but the JAX package's rule,
    which pairs bubble arms by junction ids alone, pairs the arm X -> Y
    with the loop back Y -> X and pops one, leaving a straight with copies
    of the unit cut out (ROADMAP.md Queue 3).  The port keeps that rule:
    its GFA equals JAX's line for line, the fault included, and without
    bubble popping every straight of both is a genome substring."""
    genome, reads = tandem_reads()
    rc = jsim.revcomp(genome)
    cfg = dict(k=25, chunk_len=512, log_path=None)
    t = t_assemble(reads, TConfig(pop_bubbles=True, **cfg),
                   write_output=False, device="cpu")
    j = j_assemble(reads, JConfig(pop_bubbles=True, **cfg),
                   write_output=False)
    t_plain = t_assemble(reads, TConfig(**cfg), write_output=False,
                         device="cpu")
    j_plain = j_assemble(reads, JConfig(**cfg), write_output=False)
    assert t.gfa_lines == j.gfa_lines
    assert t_plain.gfa_lines == j_plain.gfa_lines
    assert t.stats["simplify_drops"] >= 1
    assert any(s not in genome and s not in rc for s in t.straight_seqs)
    assert all(s in genome or s in rc for s in t_plain.straight_seqs)
