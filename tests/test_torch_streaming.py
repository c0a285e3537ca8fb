"""Streaming in the port against the JAX package's streaming: the GFA line
for line, tolerance "exact".

``platanus3_tpu_torch.streaming.assemble_streaming`` on the CPU (the
kernels' plain versions) against ``platanus3_tpu.streaming
.assemble_streaming`` on the inputs of ``tests/test_streaming.py``: the
random genome, the repeat genome, and tips and bubbles.  The JAX result
does not depend on the slice size, so one JAX run per input (a
module-scoped fixture) is held against the port at 8 and at 16 chunks a
slice.  Bloom membership is in ``test_torch_streaming_bloom.py``.
"""

import inspect

import numpy as np
import pytest
import torch

from platanus3_tpu import sim as jsim
from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.pipeline import assemble as j_assemble
from platanus3_tpu.streaming import assemble_streaming as j_streaming
from platanus3_tpu_torch import cli as t_cli
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.pipeline import assemble as t_assemble
from platanus3_tpu_torch.streaming import assemble_streaming as t_streaming

BASES = "ACGT"


def rand_genome(n, rng):
    return "".join(rng.choice(list(BASES), size=n))


def tiled_reads(genome, read_len, step):
    return [genome[s:s + read_len]
            for s in range(0, len(genome) - read_len + 1, step)]


def random_case():
    genome = rand_genome(4000, np.random.default_rng(83))
    return tiled_reads(genome, 300, 60), dict(k=25, chunk_len=256)


def repeat_case():
    rng = np.random.default_rng(87)
    rep = rand_genome(120, rng)
    genome = (rand_genome(700, rng) + rep + rand_genome(700, rng) + rep
              + rand_genome(700, rng))
    return tiled_reads(genome, 180, 35), dict(k=25, chunk_len=512)


def simplify_case():
    hap1 = jsim.random_genome(3000, seed=60)
    hap2 = jsim.mutate_genome(hap1, 2, seed=61, min_gap=300)
    reads = (jsim.simulate_reads(hap1, 15, 300, seed=62, sub_rate=0.004)
             + jsim.simulate_reads(hap2, 15, 300, seed=63, sub_rate=0.004))
    return reads, dict(k=25, cov_threshold=3, chunk_len=256,
                       clip_tips=True, pop_bubbles=True)


CASES = {"random": random_case, "repeat": repeat_case,
         "simplify": simplify_case}


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX streaming run per input, made when first asked for."""
    runs = {}

    def get(name):
        if name not in runs:
            reads, kw = CASES[name]()
            res = j_streaming(reads, JConfig(log_path=None, **kw),
                              write_output=False, slice_chunks=8)
            runs[name] = (reads, kw, res)
        return runs[name]
    return get


@pytest.mark.parametrize("slice_chunks", [8, 16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_streaming_gfa_identical(jax_runs, name, slice_chunks):
    reads, kw, j = jax_runs(name)
    t = t_streaming(reads, TConfig(log_path=None, **kw), write_output=False,
                    slice_chunks=slice_chunks, device="cpu")
    assert t.gfa_lines == j.gfa_lines
    assert t.straight_seqs == j.straight_seqs
    assert (t.num_nodes, t.num_straights, t.num_junctions) == \
        (j.num_nodes, j.num_straights, j.num_junctions)
    assert t.num_straights >= 1
    if kw.get("clip_tips"):
        assert t.stats["simplify_drops"] >= 1


def test_streaming_equals_single_shot_and_logs_spans():
    """In exact membership streaming equals the port's single shot, and
    its stats line carries the streaming spans."""
    reads, kw = random_case()
    cfg = TConfig(log_path=None, **kw)
    s = t_streaming(reads, cfg, write_output=False, slice_chunks=16,
                    device="cpu")
    shot = t_assemble(reads, cfg, write_output=False, device="cpu")
    assert s.gfa_lines == shot.gfa_lines
    assert list(s.stats["stages"]) == [
        "load", "pass1_histogram", "pass1_collect", "pass1_count",
        "pass2_histogram", "pass2_collect", "pass2_dedup", "pass2_table",
        "graph", "coverage", "simplify", "reach_chars", "emit"]
    assert s.stats["solid_nodes"] == shot.stats["solid_nodes"]


@pytest.mark.parametrize("cap,match", [
    (dict(short_cap=64), "short_cap"),
    (dict(node_cap=64), "node_cap"),
])
def test_streaming_declared_cap_overflow_raises(cap, match):
    genome = rand_genome(3000, np.random.default_rng(83))
    reads = tiled_reads(genome, 300, 60)
    with pytest.raises(RuntimeError, match=match):
        t_streaming(reads, TConfig(k=25, chunk_len=256, log_path=None),
                    write_output=False, slice_chunks=16, device="cpu", **cap)


def test_streaming_cli_matches_jax(tmp_path, jax_runs):
    reads, kw, j = jax_runs("repeat")
    fasta = tmp_path / "reads.fasta"
    fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    out = tmp_path / "out.gfa"
    rc = t_cli.main(["-i", str(fasta), "--streaming", "--slice-chunks", "8",
                     "--chunk-len", str(kw["chunk_len"]), "-o", str(out),
                     "--log", "", "--device", "cpu"])
    assert rc == 0
    assert out.read_text().splitlines() == j.gfa_lines


def test_streaming_defaults_to_the_card(monkeypatch):
    default = inspect.signature(t_streaming).parameters["device"].default
    assert default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_streaming(["ACGT" * 20], TConfig(log_path=None),
                    write_output=False)


def test_streaming_mesh_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        t_streaming(["ACGT" * 20], TConfig(log_path=None),
                    write_output=False, mesh=object(), device="cpu")


def test_streaming_without_reads_of_k_bases():
    """No read of k bases: the header-only GFA of the single-shot
    pipelines (the JAX package's streaming fails on this input)."""
    cfg = dict(k=25, chunk_len=256, log_path=None)
    t = t_streaming(["ACGT" * 3], TConfig(**cfg), write_output=False,
                    device="cpu")
    j = j_assemble(["ACGT" * 3], JConfig(**cfg), write_output=False)
    assert t.gfa_lines == j.gfa_lines == ["H\tVN:Z:1.0"]
