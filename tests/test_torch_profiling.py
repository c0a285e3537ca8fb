"""Tracing in the port: ``trace_dir`` wraps ``assemble`` and
``assemble_streaming`` in a ``torch.profiler`` trace and writes it as a
Chrome trace (``trace.json``); on the CPU it holds CPU activity only.
"""

import json

import numpy as np
import pytest

from platanus3_tpu_torch import cli as t_cli
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.pipeline import assemble
from platanus3_tpu_torch.streaming import assemble_streaming
from platanus3_tpu_torch.utils.profiling import TRACE_FILE, TRACE_WINDOW


def reads():
    genome = "".join(np.random.default_rng(4).choice(list("ACGT"), size=300))
    return [genome[i:i + 60] for i in range(0, 240, 30)] * 2


def events(trace_dir):
    trace = json.loads((trace_dir / TRACE_FILE).read_text())
    return trace["traceEvents"]


@pytest.mark.parametrize("entry", [assemble, assemble_streaming])
def test_trace_dir_writes_a_trace(tmp_path, entry):
    td = tmp_path / "trace"
    cfg = TConfig(k=25, chunk_len=256, trace_dir=str(td), log_path=None,
                  profile_stages=True)
    res = entry(reads(), cfg, write_output=False, device="cpu")
    assert res.num_straights >= 1
    evs = events(td)
    names = {e.get("name") for e in evs}
    assert any(n and n.startswith("aten::sort") for n in names)
    assert not any(e.get("cat") == "kernel" for e in evs)
    # one event spans the run: every operator's event lies inside it
    (window,) = [e for e in evs if e.get("name") == TRACE_WINDOW]
    end = window["ts"] + window["dur"]
    assert all(window["ts"] <= e["ts"] <= end for e in evs
               if e.get("cat") == "cpu_op")


def test_cli_trace_dir(tmp_path):
    fasta = tmp_path / "r.fasta"
    fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads())))
    td = tmp_path / "trace"
    rc = t_cli.main(["-i", str(fasta), "--chunk-len", "256", "--trace-dir",
                     str(td), "-o", str(tmp_path / "o.gfa"), "--log", "",
                     "--device", "cpu"])
    assert rc == 0 and len(events(td)) > 100
