"""The readers of the program's stage 4 parts and host-sync counter
(``emit_text_s``, ``host_syncs``) on synthetic stats lines, and the span
readers unchanged by the parts and the ``finish`` span beside them."""

from __future__ import annotations

from pathlib import Path

import pytest

from asmbench import run, spec
from asmbench.tests import tiny


def _job(stages, launches=1):
    return run.Job(seconds=1.0, ok=True, gfa=Path("x"), log=Path("y"),
                   launches=launches, stats={"stages": stages})


_SHOT = [{"load": 0.2, "stage1_count_solid": 0.4, "bloom_build": 0.05,
          "stage2_graph": 0.2, "stage3_coverage": 0.1, "stage4_emit": 0.1},
         {"load": 0.4, "stage1_count_solid": 0.6, "bloom_build": 0.05,
          "stage2_graph": 0.2, "stage3_coverage": 0.2, "stage4_emit": 0.3}]
_STREAM = [{"load": 1.0, "pass1_histogram": 0.5, "pass1_collect": 0.5,
            "pass1_count": 0.5, "pass2_histogram": 0.5, "pass2_collect": 0.5,
            "pass2_dedup": 0.25, "pass2_table": 0.25, "graph": 1.5,
            "coverage": 1.3, "simplify": 0.0, "reach_chars": 0.5,
            "emit": 0.4}]


def _with_parts(stages):
    """``stages`` as the program logs them with stage 1's and stage 4's
    parts after their spans, and the ``finish`` span last."""
    out = {}
    for name, s in stages.items():
        out[name] = s
        if name == "stage1_count_solid":
            out.update({"stage1.solid": s / 2, "stage1.seeds": s / 8,
                        "stage1.node_ids": s / 4})
        if name in ("stage4_emit", "emit"):
            out.update({"emit.pack": s / 4, "emit.to_host": s / 8,
                        "emit.text": s / 2, "emit.write": s / 16})
    out["finish"] = 0.01
    return out


def _span_run(stages_list, counts=None):
    jobs = [_job(stages) for stages in stages_list]
    for j, c in zip(jobs, counts or []):
        j.stats["counts"] = c
    return run.Run(params={}, jobs=jobs, traced=0, trace=None, ref=None,
                   chunks=0, cold_s=1.0, device_kind="cpu")


def _read(metric, r):
    return spec.load_module(tiny.HOME / "metrics" / f"{metric}.py").read(r)


@pytest.mark.parametrize("metric", ["load_s", "stage1_s", "passes_s",
                                    "graph_s", "coverage_s", "emit_s"])
@pytest.mark.parametrize("jobs", [_SHOT, _STREAM], ids=["shot", "stream"])
def test_span_metrics_read_the_same_with_parts_and_finish(metric, jobs):
    before = _read(metric, _span_run(jobs))
    after = _read(metric, _span_run([_with_parts(j) for j in jobs]))
    assert after == (pytest.approx(before) if before is not None else None)


@pytest.mark.parametrize("jobs,want", [
    ([_with_parts(j) for j in _SHOT], (0.1 + 0.3) * (1 / 2 + 1 / 16) / 2),
    ([_with_parts(j) for j in _STREAM], 0.4 * (1 / 2 + 1 / 16)),
    (_SHOT, None),      # a program without the parts
])
def test_emit_text_s_reads_the_text_and_write_parts(jobs, want):
    got = _read("emit_text_s", _span_run(jobs))
    assert got == (pytest.approx(want) if want is not None else None)


def test_host_syncs_reads_each_jobs_rise_once():
    jobs = [_with_parts(j) for j in _SHOT]
    counts = [{"bloom_set_bits_launches": 1, "host_syncs": 120},
              {"bloom_set_bits_launches": 1, "host_syncs": 80}]
    r = _span_run(jobs, counts)
    # the parts' rises, counted again in their spans, are not read
    for j in r.jobs:
        j.stats["span_counts"] = {
            name: {"host_syncs": 10} for name in j.stats["stages"]}
    assert _read("host_syncs", r) == pytest.approx(100.0)


@pytest.mark.parametrize("counts", [
    None,                                         # a line without counts
    [{"bloom_set_bits_launches": 1}] * 2,         # tracing off, or the CPU
    [{"host_syncs": 3}, {"bloom_set_bits_launches": 1}],
])
def test_host_syncs_is_none_without_the_counter(counts):
    assert _read("host_syncs", _span_run(_SHOT, counts)) is None
