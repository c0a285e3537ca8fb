"""The window, rate, span, roofline and idle-share arithmetic on synthetic
jobs and traces."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from asmbench import compare, run, spec, trace, yardstick
from asmbench.references.debruijn import Assembly
from asmbench.tests import tiny
from asmbench.traffic import gen


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seconds,durations,want_jobs,want_window", [
    (10.0, [3.0], 4, 12.0),        # the first job ending at or past 10 s
    (9.0, [3.0], 3, 9.0),          # ends exactly at the limit
    (1.0, [5.0], 1, 5.0),          # one job longer than the window
    (0.0, [2.0], 1, 2.0),          # at least one job
    (10.0, [1.0, 8.0], 3, 10.0),   # uneven jobs
])
def test_window_closes_after_the_first_job_past_its_length(
        seconds, durations, want_jobs, want_window):
    clock = Clock()
    jobs = []

    def job(i):
        clock.t += durations[i % len(durations)]
        return i

    window = run.run_window(job, seconds, jobs, clock.t, clock=clock)
    assert len(jobs) == want_jobs
    assert window == pytest.approx(want_window)


def test_rate_counts_every_job_over_the_whole_window():
    e2e = run.end_to_end(bases=92_830_000, n_jobs=30, window_s=30.5,
                         peak_bytes=17_000_000_000, setup_s=12.0)
    assert e2e["asm_mbases_per_s"] == pytest.approx(92.83 * 30 / 30.5)
    assert e2e["peak_device_gb"] == pytest.approx(17.0)
    assert e2e["setup_s"] == 12.0


def _trace_file(tmp_path: Path) -> Path:
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "gpu_user_annotation", "name": trace.WINDOW,
         "ts": 900, "dur": 3000},
        {"ph": "X", "cat": "user_annotation", "name": trace.JOB,
         "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 1100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 1250, "dur": 150},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 1900,
         "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 2500, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 1350,
         "dur": 600},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1450,
         "dur": 10},
        {"ph": "i", "cat": "cpu_op", "name": "instant", "ts": 1500},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_busy_idle_and_gaps(tmp_path):
    spans = [{"load": 0.0002, "stage1_count_solid": 0.0008}]
    s = trace.summarize(_trace_file(tmp_path), spans)
    # Busy: [1100, 1400] and [1900, 2000] (the copy clipped at the window's
    # end); the kernel at 2500 lies outside the window.
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(400e-6)
    assert s.kernels == {"k_a": pytest.approx(200e-6),
                         "k_b": pytest.approx(150e-6)}
    assert [g[0] for g in s.gaps] == ["stage1_count_solid:aten::sort",
                                      "load:host"]
    assert [g[1] for g in s.gaps] == [pytest.approx(500e-6),
                                      pytest.approx(100e-6)]
    r = run.Run(params={}, jobs=[], traced=1, trace=s, ref=None, chunks=0,
                cold_s=1.0, device_kind="NVIDIA H100 80GB HBM3")
    idle = spec.load_module(tiny.HOME / "metrics" / "device_idle_share.py")
    assert idle.read(r) == pytest.approx(60.0)


def test_union_merges_and_clips():
    assert trace.union([(5, 7), (0, 2), (1, 3), (6, 12)], 1, 10) == [
        [1, 3], [5, 10]]


def _job(stages, launches=1):
    return run.Job(seconds=1.0, ok=True, gfa=Path("x"), log=Path("y"),
                   launches=launches, stats={"stages": stages})


@pytest.mark.parametrize("metric,want", [
    ("load_s", 0.3), ("stage1_s", 0.5), ("graph_s", 0.25),
    ("coverage_s", 0.15), ("emit_s", 0.2), ("passes_s", None)])
def test_span_metrics_single_shot(metric, want):
    jobs = [_job({"load": 0.2, "stage1_count_solid": 0.4,
                  "bloom_build": 0.05, "stage2_graph": 0.2,
                  "stage3_coverage": 0.1, "stage4_emit": 0.1}),
            _job({"load": 0.4, "stage1_count_solid": 0.6,
                  "bloom_build": 0.05, "stage2_graph": 0.2,
                  "stage3_coverage": 0.2, "stage4_emit": 0.3})]
    r = run.Run(params={}, jobs=jobs, traced=0, trace=None, ref=None,
                chunks=0, cold_s=1.0, device_kind="cpu")
    got = spec.load_module(tiny.HOME / "metrics" / f"{metric}.py").read(r)
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("metric,want", [
    ("passes_s", 3.0), ("graph_s", 1.5), ("coverage_s", 1.8),
    ("emit_s", 0.4), ("stage1_s", None)])
def test_span_metrics_streaming(metric, want):
    jobs = [_job({"load": 1.0, "pass1_histogram": 0.5, "pass1_collect": 0.5,
                  "pass1_count": 0.5, "pass2_histogram": 0.5,
                  "pass2_collect": 0.5, "pass2_dedup": 0.25,
                  "pass2_table": 0.25, "graph": 1.5, "coverage": 1.3,
                  "simplify": 0.0, "reach_chars": 0.5, "emit": 0.4})]
    r = run.Run(params={}, jobs=jobs, traced=0, trace=None, ref=None,
                chunks=0, cold_s=1.0, device_kind="cpu")
    got = spec.load_module(tiny.HOME / "metrics" / f"{metric}.py").read(r)
    assert got == (pytest.approx(want) if want is not None else None)


def test_graph_cap_matches_the_main_runs_node_table():
    # E. coli's 4,641,652 nodes go to a 5,242,880-row table (PERF.md).
    assert yardstick.graph_cap(4_641_652) == 5_242_880
    assert yardstick.graph_cap(1000) == 1024
    assert yardstick.graph_cap(1) == 8


def test_bloom_set_bits_bytes():
    single = {"k": 32, "chunk_len": 1024, "filter_bits": 1 << 30}
    assert yardstick.bloom_set_bits_bytes(single, 1, 4_641_652, 0, 0) == (
        5_242_880 + 4_641_652 * 2 * 8 + 2 * (1 << 27))
    stream = {"k": 25, "chunk_len": 4096, "filter_bits": 1 << 33,
              "streaming": True}
    assert yardstick.bloom_set_bits_bytes(stream, 35, 0, 500_000_000,
                                          140_128) == (
        140_128 * 4072 + 500_000_000 * 16 + 35 * 2 * (1 << 30))


def test_num_chunks():
    offs = np.array([0, 8000, 16000, 16010, 20106])
    # 8000 bases at chunk 4096, k 25: stride 4072, (8000-25)//4072+1 = 2;
    # a 10-base read is shorter than k; 4096 bases: 1 chunk.
    assert yardstick.num_chunks(offs, 25, 4096) == 2 + 2 + 1


def test_bloom_roofline_reads_only_its_kernels():
    s = trace.TraceSummary(window_s=1.0, busy_s=0.5, kernels={
        "void partition_count_kernel<BloomRows<false> >(BloomRows<false>)":
            0.0002,
        "void partition_refine_kernel<BloomRefine>(BloomRefine)": 0.0003,
        "bloom_region_or_kernel(unsigned int const*)": 0.0005,
        "void partition_count_kernel<OaRows>(OaRows)": 1.0,
        "void at::native::elementwise_kernel<128, 2>": 1.0}, gaps=[],
        device_events=5)
    params = {"k": 32, "chunk_len": 1024, "filter_bits": 1 << 30}
    ref = Assembly(gfa="", solid_nodes=4_641_652, solid_positions=0,
                   straights=0, junctions=0, links=0)
    r = run.Run(params=params, jobs=[_job({}, launches=1)], traced=1,
                trace=s, ref=ref, chunks=0, cold_s=1.0,
                device_kind="NVIDIA H100 80GB HBM3")
    reader = spec.load_module(tiny.HOME / "metrics" /
                              "bloom_set_bits_roofline.py")
    least = yardstick.bloom_set_bits_bytes(params, 1, 4_641_652, 0, 0) / 3.35e12
    assert reader.read(r) == pytest.approx(100 * least / 0.001)
    r.device_kind = "cpu"
    assert reader.read(r) is None


def test_line_diff_counts_each_kind():
    want = "H\tVN:Z:1.0\nS\tStraight_1\tACGT\tKC:i:4\nS\tJunction_1\tAC\tKC:i:2\nL\ta\n"
    got = "H\tVN:Z:1.0\nS\tStraight_1\tACGA\tKC:i:4\nS\tJunction_1\tAC\tKC:i:2\n"
    d = compare.line_diff(got, want)
    assert d == {"lines_differ": 3, "straights_differ": 2,
                 "junctions_differ": 0, "links_differ": 1}
    ref = Assembly(gfa=want, solid_nodes=10, solid_positions=0, straights=1,
                   junctions=1, links=1)
    c = compare.checks([(want, 10), (got, 9), (None, None)], ref)
    assert c["jobs_differ"]["value"] == 2
    assert c["lines_differ"]["value"] == 4
    assert c["solid_nodes_differ"]["value"] == 10
    assert all(v["limit"] == 0 for v in c.values())


def _revcomp(codes):
    return 3 - codes[::-1]


def test_reads_share_their_lengths_across_seeds():
    """Every seed reads the same set of lengths, in another order, at
    other places on the genome."""
    mix = dict(tiny.TRAFFIC, sub_rate=0.0, ins_rate=0.0, del_rate=0.0)
    genome = gen.make_genome({"kind": "random", "length": 30000},
                             gen.make_rng(1, 1))
    sets = []
    for seed in (5, 2**31 + 11):
        codes, offs = gen.simulate_reads(genome, mix, gen.make_rng(seed, 2),
                                         gen.make_rng(1, 3))
        lens = np.diff(offs)
        sets.append(lens)
        text = genome.tobytes()
        for i in range(lens.shape[0]):   # error-free: each read is on it
            r = codes[offs[i]:offs[i + 1]]
            assert (r.tobytes() in text) or (_revcomp(r).tobytes() in text)
    assert np.array_equal(np.sort(sets[0]), np.sort(sets[1]))
    assert not np.array_equal(sets[0], sets[1])
    assert sets[0].min() >= mix["min_read_len"]


def test_read_errors_follow_their_rates():
    """Substitutions, insertions and deletions at the mix's rates, and
    reversed reads as reverse complements."""
    genome = gen.make_genome({"kind": "random", "length": 200000},
                             gen.make_rng(2, 1))
    starts = np.arange(0, 190000, 5000)
    lens = np.full(starts.shape, 5000)
    fwd = np.zeros(starts.shape, dtype=bool)
    want = np.concatenate([genome[a:a + 5000] for a in starts])
    codes, got = gen._read_block(genome, starts, lens, fwd,
                                 {"sub_rate": 0.01}, gen.make_rng(9, 2))
    assert np.array_equal(got, lens)
    assert abs((codes != want).mean() - 0.01) < 0.002
    codes, got = gen._read_block(genome, starts, lens, fwd,
                                 {"ins_rate": 0.006, "del_rate": 0.003},
                                 gen.make_rng(9, 2))
    assert codes.shape[0] == got.sum()
    assert abs(got.sum() / lens.sum() - 1.003) < 0.001
    codes, _ = gen._read_block(genome, starts, lens, ~fwd, {},
                               gen.make_rng(9, 2))
    assert np.array_equal(codes[5000:10000],
                          _revcomp(genome[starts[1]:starts[1] + 5000]))
