"""Multi-k through streaming, and multi-k from a read file, in the port
against the JAX package: the GFA line for line, tolerance "exact".
"""

import inspect

import pytest
import torch

from platanus3_tpu import sim as jsim
from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.graph.multik import assemble_multik as j_multik
from platanus3_tpu_torch import cli as t_cli
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.graph.multik import assemble_multik as t_multik

KW = dict(k=25, k_list=(25, 33), cov_threshold=3, chunk_len=256,
          clip_tips=True, log_path=None)


def reads():
    genome = jsim.random_genome(3000, seed=64)
    return jsim.simulate_reads(genome, coverage=15, read_len=300, seed=65,
                               sub_rate=0.005)


def test_multik_streaming_gfa_identical():
    rs = reads()
    j = j_multik(rs, JConfig(**KW), write_output=False, streaming=True,
                 slice_chunks=8)
    t = t_multik(rs, TConfig(**KW), write_output=False, streaming=True,
                 slice_chunks=8, device="cpu")
    assert t.gfa_lines == j.gfa_lines
    assert t.stats["k"] == 33 and t.num_straights >= 1
    shot = t_multik(rs, TConfig(**KW), write_output=False, device="cpu")
    assert shot.stats["k"] == 33


def test_multik_from_file_loads_each_round_natively(tmp_path):
    """A file source is loaded again for every k through the native
    loader; the GFA equals the JAX package's, which parses the file once
    and chunks the strings per k."""
    fasta = tmp_path / "reads.fasta"
    fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads())))
    out, log = tmp_path / "out.gfa", tmp_path / "run.log"
    rc = t_cli.main(["-i", str(fasta), "--k-list", "25,33", "--clip-tips",
                     "--cov-threshold", "3", "--chunk-len", "256",
                     "--streaming", "-o", str(out), "--log", str(log),
                     "--device", "cpu"])
    assert rc == 0
    j = j_multik(str(fasta), JConfig(**KW), write_output=False)
    assert out.read_text().splitlines() == j.gfa_lines
    # several k: the CLI runs single-shot multi-k, as the JAX CLI does
    assert "[streaming]" not in log.read_text()


def test_multik_defaults_to_the_card(monkeypatch):
    assert inspect.signature(t_multik).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_multik(reads(), TConfig(**KW), write_output=False, streaming=True)
