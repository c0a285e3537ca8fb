"""End-to-end: the port's GFA line list equals the JAX package's.

``platanus3_tpu_torch.pipeline.assemble`` on the CPU (plain PyTorch
versions of the kernels) against ``platanus3_tpu.pipeline.assemble`` on
inputs the size of ``tests/test_pipeline.py``'s: exact membership at
k = 25, Bloom membership at k = 25 with a filter small enough to force
phantom (false-positive) nodes, and Bloom membership at k = 32.
"""

import inspect

import numpy as np
import pytest
import torch

from platanus3_tpu import sim as jsim
from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.pipeline import assemble as j_assemble
from platanus3_tpu_torch import cli as t_cli
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.pipeline import assemble as t_assemble

RNG = np.random.default_rng(17)


def rand_genome(n):
    return "".join(RNG.choice(list("ACGT"), size=n))


def tiled(genome, read_len, step):
    return [genome[s:s + read_len]
            for s in range(0, max(1, len(genome) - read_len + 1), step)]


def both(reads, **kw):
    kw.setdefault("chunk_len", 256)
    kw.setdefault("log_path", None)
    j = j_assemble(list(reads), JConfig(**kw), write_output=False)
    t = t_assemble(list(reads), TConfig(**kw), write_output=False,
                   device="cpu")
    return j, t


def _inputs():
    g = rand_genome(2000)
    prefix = rand_genome(80)
    a, b = prefix + rand_genome(60), prefix + rand_genome(60)
    circ = rand_genome(300)
    noisy_g = jsim.random_genome(2500, seed=41)
    return {
        "linear": (tiled(g, 250, 50), dict(chunk_len=512)),
        "branch": ([a, a, b, b], {}),
        "circular": (tiled(circ + circ[:100], 120, 30), {}),
        "duplicated": ([g[:60], g[:60]], {}),
        "noisy": (jsim.simulate_reads(noisy_g, coverage=25, read_len=250,
                                      seed=42, sub_rate=0.01),
                  dict(chunk_len=512)),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_exact_k25_gfa_identical(name):
    reads, kw = INPUTS[name]
    j, t = both(reads, k=25, **kw)
    assert t.gfa_lines == j.gfa_lines
    assert t.straight_seqs == j.straight_seqs
    assert (t.num_nodes, t.num_straights, t.num_junctions) == \
        (j.num_nodes, j.num_straights, j.num_junctions)
    assert t.num_straights >= 1


def test_bloom_k25_phantom_nodes_gfa_identical():
    genome = jsim.random_genome(300, seed=51)
    reads = jsim.simulate_reads(genome, coverage=25, read_len=120, seed=52)
    j, t = both(reads, k=25, use_exact_membership=False,
                filter_bits=1 << 12, num_hashes=2)
    # false positives were materialized as nodes beyond the solid set
    assert t.num_nodes > t.stats["solid_nodes"]
    assert t.stats["closure_rounds"] >= 1
    assert any(ln.startswith("S\tJunction") and ln.endswith("KC:i:0")
               for ln in t.gfa_lines)
    assert t.gfa_lines == j.gfa_lines
    assert t.num_nodes == j.num_nodes


@pytest.mark.parametrize("name", ["linear", "noisy"])
def test_bloom_k32_gfa_identical(name):
    reads, kw = INPUTS[name]
    j, t = both(reads, k=32, use_exact_membership=False, **kw)
    assert t.gfa_lines == j.gfa_lines
    assert t.num_straights >= 1


def test_read_batch_from_jax_package():
    from platanus3_tpu.io import reads as jreads
    from platanus3_tpu_torch import interop
    reads, kw = INPUTS["noisy"]
    batch = interop.from_numpy_read_batch(
        jreads.reads_from_strings(reads, 25, kw["chunk_len"]))
    t = t_assemble(batch, TConfig(k=25, log_path=None, **kw),
                   write_output=False, device="cpu")
    j = j_assemble(list(reads), JConfig(k=25, log_path=None, **kw),
                   write_output=False)
    assert t.gfa_lines == j.gfa_lines


def test_no_seed_restrict_and_short_reads():
    reads, kw = INPUTS["branch"]
    j, t = both(reads, k=25, restrict_to_seeds=False, **kw)
    assert t.gfa_lines == j.gfa_lines
    j, t = both(["ACGT" * 4], k=25)
    assert t.gfa_lines == j.gfa_lines == ["H\tVN:Z:1.0"]


def test_cli_bloom_run_matches_jax(tmp_path):
    reads, _ = INPUTS["noisy"]
    fasta = tmp_path / "reads.fasta"
    fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    out, log = tmp_path / "out.gfa", tmp_path / "run.log"
    rc = t_cli.main(["-i", str(fasta), "-k", "32", "-m", str(1 << 16),
                     "--membership", "bloom", "--chunk-len", "512",
                     "-o", str(out), "--log", str(log), "--device", "cpu",
                     "--fasta-out", str(tmp_path / "contigs.fasta")])
    assert rc == 0
    j = j_assemble(str(fasta), JConfig(k=32, filter_bits=1 << 16,
                                       chunk_len=512, log_path=None,
                                       use_exact_membership=False),
                   write_output=False)
    assert out.read_text().splitlines() == j.gfa_lines
    assert "stats {" in log.read_text()
    assert (tmp_path / "contigs.fasta").read_text().startswith(">Straight_1")


def test_assemble_defaults_to_the_card(monkeypatch):
    """The library entry point runs on the card unless asked for the CPU,
    and without a card it raises instead of falling back."""
    default = inspect.signature(t_assemble).parameters["device"].default
    assert default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_assemble([rand_genome(80)] * 2,
                   TConfig(chunk_len=256, log_path=None), write_output=False)
