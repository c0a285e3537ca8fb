"""Tracing in the port: ``trace_dir`` wraps ``assemble`` and
``assemble_streaming`` in a ``torch.profiler`` trace and writes it as a
Chrome trace (``trace.json``); on the CPU it holds CPU activity only.
Each span of ``StageTimer`` is a ``p3.<span>`` range in it; the spans
tile the run; with tracing off the timer touches no process-wide state.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from platanus3_tpu_torch import cli as t_cli
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.pipeline import assemble
from platanus3_tpu_torch.streaming import assemble_streaming
from platanus3_tpu_torch.utils.profiling import (RANGE_PREFIX, SYNC_WARNING,
                                                 TRACE_FILE, TRACE_WINDOW,
                                                 StageTimer)


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


def ranges(evs, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in evs
            if e.get("name") == name and e.get("cat") == "user_annotation"]


@pytest.fixture
def one_thread():
    """One intra-op thread: with several, on a machine whose cores other
    processes share, the pool's spinning workers can take the host thread
    off its core for a scheduler slice right after an operator, between
    the timer's clock reading and the profiler's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("profile", [False, True])
@pytest.mark.parametrize("entry", [assemble, assemble_streaming])
def test_trace_holds_a_range_for_every_span(tmp_path, entry, profile,
                                             one_thread):
    """One range a span, inside the traced window, a part's inside its
    span's; each range's duration agrees with its span within 1 ms + 5 %.
    The two clocks are read a few microseconds apart at each boundary, and
    a process the scheduler stops between the readings shifts a boundary
    by its time slice; so the durations are compared over three runs, and
    each span has to agree in one of them."""
    agreed = set()
    for run in range(3):
        td = tmp_path / f"trace{run}"
        cfg = TConfig(k=25, chunk_len=256, trace_dir=str(td), log_path=None,
                      profile_stages=profile)
        stages = entry(reads(), cfg, write_output=False,
                       device="cpu").stats["stages"]
        assert {"load", "emit.pack", "emit.to_host", "emit.text",
                "emit.write", "finish"} <= set(stages)
        evs = events(td)
        (window,) = ranges(evs, TRACE_WINDOW)
        span = None
        for name, seconds in stages.items():
            (rng,) = ranges(evs, RANGE_PREFIX + name)
            assert window[0] <= rng[0] <= rng[1] <= window[1]
            if "." in name:      # a part lies inside its span's range
                assert span[0] <= rng[0] <= rng[1] <= span[1]
            else:
                span = rng
            if abs((rng[1] - rng[0]) / 1e6 - seconds) <= 1e-3 + 0.05 * seconds:
                agreed.add(name)
        # no other program range
        assert {e["name"] for e in evs if e.get("cat") == "user_annotation"
                and e["name"].startswith(RANGE_PREFIX)} == {
            RANGE_PREFIX + n for n in stages}
    assert agreed == set(stages)


@pytest.mark.parametrize("entry", [assemble, assemble_streaming])
def test_top_level_spans_tile_the_run(entry):
    stats = entry(reads(), TConfig(k=25, chunk_len=256, log_path=None),
                  write_output=False, device="cpu").stats
    top = [s for name, s in stats["stages"].items() if "." not in name]
    assert top[-1] == stats["stages"]["finish"]
    assert sum(top) == pytest.approx(stats["elapsed_s"], rel=1e-9, abs=1e-9)
    assert stats["counts"] == {"bloom_set_bits_launches": 0,
                               "slice_kmers_launches": 0,
                               "coverage_tally_launches": 0}
    assert set(stats["span_counts"]) == set(stats["stages"])


PROCESS_WIDE = ("reset_peak_memory_stats", "max_memory_allocated",
                "max_memory_reserved", "set_sync_debug_mode",
                "get_sync_debug_mode", "synchronize")


def cuda_stubs(monkeypatch):
    """Record each call of the process-wide ``torch.cuda`` functions the
    timer may use; ``synchronize`` warns as a sync would."""
    calls = []

    def stub(name):
        def f(*args):
            calls.append((name, args))
            if name == "synchronize":
                warnings.warn(SYNC_WARNING)
            return 0
        return f

    for name in PROCESS_WIDE:
        monkeypatch.setattr(torch.cuda, name, stub(name))
    return calls


def run_spans(timer):
    with timer:
        timer.begin("a")
        with timer.part("a.part"):
            warnings.warn(SYNC_WARNING + " (planted)")
        timer.begin("b")
        warnings.warn("another warning")
    return timer


def test_tracing_off_touches_no_process_wide_state(monkeypatch):
    calls = cuda_stubs(monkeypatch)
    with pytest.warns(UserWarning) as seen:
        timer = run_spans(StageTimer(device="cuda"))
    assert calls == []
    assert timer.peak_bytes == {} and "host_syncs" not in timer.counts()
    # sync warnings pass through untouched when tracing is off
    assert len(seen) == 2


def test_tracing_on_counts_syncs_per_span(monkeypatch):
    calls = cuda_stubs(monkeypatch)
    filters = list(warnings.filters)
    with pytest.warns(UserWarning, match="another warning") as seen:
        timer = run_spans(StageTimer(profile=True, device="cuda"))
    assert len(seen) == 1                 # the sync warning was counted
    assert ("set_sync_debug_mode", ("warn",)) in calls
    assert calls[-1] == ("set_sync_debug_mode", (0,))       # restored
    assert warnings.filters == filters
    assert sum(1 for c in calls if c[0] == "synchronize") >= 4
    # the planted sync counts once in its part and once in its span; the
    # barriers, which warn here too, count nowhere
    assert timer.span_counts["a.part"]["host_syncs"] == 1
    assert timer.span_counts["a"]["host_syncs"] == 1
    assert timer.span_counts["b"]["host_syncs"] == 0
    assert timer.counts() == {"host_syncs": 1}
    assert set(timer.peak_bytes) == {"a", "b"}


def test_tracing_state_restored_on_error(monkeypatch):
    calls = cuda_stubs(monkeypatch)
    filters = list(warnings.filters)
    timer = StageTimer(profile=True, device="cuda")
    with pytest.raises(RuntimeError, match="boom"):
        with timer:
            timer.begin("a")
            with timer.part("a.part"):
                raise RuntimeError("boom")
    assert calls[-1] == ("set_sync_debug_mode", (0,))
    assert warnings.filters == filters
    assert set(timer.spans) == {"a", "a.part"}
