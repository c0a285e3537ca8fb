"""The readers of the Bloom chr21 cell (``stream_bloom_insert_s``,
``bloom_query_s``, ``stream_bloom_set_bits_roofline``) on synthetic stats
lines and traces, the byte count of one slice's ``bloom_set_bits``
launch, and the span readers unchanged by the two new parts."""

from __future__ import annotations

from pathlib import Path

import pytest

from asmbench import run, spec, trace, yardstick
from asmbench.references.debruijn import Assembly
from asmbench.tests import tiny

_STREAM = {"load": 1.0, "pass1_histogram": 0.5, "pass1_collect": 0.5,
           "pass1_count": 0.5, "pass2_histogram": 0.5, "pass2_collect": 0.5,
           "pass2_dedup": 0.25, "pass2_table": 0.25, "graph": 1.5,
           "coverage": 1.3, "simplify": 0.0, "reach_chars": 0.5,
           "emit": 0.4, "finish": 0.01}
# The chr21 cell's parameters; one slice is 4096 chunks of 4072 k-mer
# starts (4096 - 25 + 1).
_CHR21 = {"k": 25, "chunk_len": 4096, "slice_chunks": 4096,
          "filter_bits": 1 << 33, "hashes": 10, "streaming": True}


def _with_bloom_parts(stages, insert, query):
    out = dict(stages)
    out["pass2.bloom_insert"] = insert
    out["graph.bloom_query"] = query
    return out


def _run(stages_list, launches=39, params=None, trace_summary=None,
         traced=0, ref=None, chunks=0, kind="cpu"):
    jobs = [run.Job(seconds=1.0, ok=True, gfa=Path("x"), log=Path("y"),
                    launches=launches, stats={"stages": s})
            for s in stages_list]
    return run.Run(params=params or {}, jobs=jobs, traced=traced,
                   trace=trace_summary, ref=ref, chunks=chunks, cold_s=1.0,
                   device_kind=kind)


def _read(metric, r):
    return spec.load_module(tiny.HOME / "metrics" / f"{metric}.py").read(r)


@pytest.mark.parametrize("metric,name", [
    ("stream_bloom_insert_s", "pass2.bloom_insert"),
    ("bloom_query_s", "graph.bloom_query")])
def test_bloom_part_readers_read_each_jobs_part(metric, name):
    jobs = [_with_bloom_parts(_STREAM, 0.04, 0.3),
            _with_bloom_parts(_STREAM, 0.06, 0.5)]
    want = {"pass2.bloom_insert": 0.05, "graph.bloom_query": 0.4}[name]
    assert _read(metric, _run(jobs)) == pytest.approx(want)
    # A program without the part (exact membership, or the parent of the
    # change that added it) gives nothing and raises nothing.
    assert _read(metric, _run([_STREAM, _STREAM])) is None


@pytest.mark.parametrize("metric", ["passes_s", "graph_s", "coverage_s",
                                    "emit_s", "emit_text_s"])
def test_span_readers_leave_the_bloom_parts_out(metric):
    before = _read(metric, _run([_STREAM]))
    after = _read(metric, _run([_with_bloom_parts(_STREAM, 0.05, 0.4)]))
    assert after == (pytest.approx(before) if before is not None else None)


def test_one_slice_launch_bytes():
    """One launch over one chr21 slice: the row mask (one byte a row), the
    lanes of its solid rows (two 8-byte lanes at k = 25) and the 2^33-bit
    filter read and written once."""
    rows = 4096 * (4096 - 25 + 1)
    assert rows == 16_678_912
    solid = 13_000_000
    assert yardstick.bloom_set_bits_bytes(_CHR21, 1, 0, solid, 4096) == (
        rows + solid * 16 + 2 * (1 << 30))


def _summary(kernels):
    return trace.TraceSummary(window_s=1.0, busy_s=0.5, kernels=kernels,
                              gaps=[], device_events=5)


_KERNELS = {
    "void p3::partition_count_kernel<(anonymous namespace)::BloomRows<true>"
    " >((anonymous namespace)::BloomRows<true>, int, int, long, unsigned "
    "int*)": 0.004,
    "void p3::partition_scatter_kernel<(anonymous namespace)::BloomRows"
    "<true> >(...)": 0.006,
    "void p3::partition_refine_kernel<(anonymous namespace)::BloomRefine, "
    "unsigned int>(...)": 0.003,
    "(anonymous namespace)::bloom_region_or_kernel(unsigned int const*)":
        0.007,
    "void p3::partition_count_kernel<(anonymous namespace)::OaRows>(...)":
        1.0,
    "slice_kmers_kernel<3>(...)": 1.0,
    "void at::native::elementwise_kernel<128, 2>": 1.0}


def test_stream_roofline_reads_only_the_bloom_passes():
    ref = Assembly(gfa="", solid_nodes=44_900_000,
                   solid_positions=500_000_000, straights=0, junctions=0,
                   links=0)
    chunks = 39 * 4096
    r = _run([_STREAM, _STREAM], launches=39, params=_CHR21,
             trace_summary=_summary(_KERNELS), traced=1, ref=ref,
             chunks=chunks, kind="NVIDIA H100 80GB HBM3")
    least = yardstick.bloom_set_bits_bytes(
        _CHR21, 39, 44_900_000, 500_000_000, chunks) / 3.35e12
    assert _read("stream_bloom_set_bits_roofline", r) == pytest.approx(
        100 * least / 0.020)
    # Another card, no trace, no launch, or a single-shot cell: nothing.
    r.device_kind = "cpu"
    assert _read("stream_bloom_set_bits_roofline", r) is None
    for change in ({"trace": None}, {"jobs": [
            run.Job(1.0, True, Path("x"), Path("y"), 0, {})]},
            {"params": {**_CHR21, "streaming": False}}):
        r2 = _run([_STREAM], launches=39, params=_CHR21,
                  trace_summary=_summary(_KERNELS), traced=1, ref=ref,
                  chunks=chunks, kind="NVIDIA H100 80GB HBM3")
        for key, value in change.items():
            setattr(r2, key, value)
        assert _read("stream_bloom_set_bits_roofline", r2) is None
