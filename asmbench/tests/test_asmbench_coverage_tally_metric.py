"""The reader of stage 3's tally part (``coverage_tally_s``) on synthetic
stats lines, single shot and streaming, and the stage 3 span reader
unchanged by the part beside it."""

from __future__ import annotations

from pathlib import Path

import pytest

from asmbench import run, spec
from asmbench.tests import tiny

_SHOT = {"load": 0.2, "stage1_count_solid": 0.4, "bloom_build": 0.05,
         "stage2_graph": 0.2, "stage3_coverage": 0.15, "stage4_emit": 0.1}
_STREAM = {"load": 1.0, "pass1_histogram": 0.5, "pass1_collect": 0.5,
           "pass1_count": 0.5, "pass2_histogram": 0.5, "pass2_collect": 0.5,
           "pass2_dedup": 0.25, "pass2_table": 0.25, "graph": 1.5,
           "coverage": 1.3, "simplify": 0.0, "reach_chars": 0.5,
           "emit": 0.4}


def _with_tally(stages, tally):
    """``stages`` with the part ``coverage.tally`` after its span, as the
    program logs it: its seconds summed over the job's slices."""
    out = {}
    for name, s in stages.items():
        out[name] = s
        if name in ("stage3_coverage", "coverage"):
            out["coverage.tally"] = tally
    return out


def _run(stages_list):
    jobs = [run.Job(seconds=1.0, ok=True, gfa=Path("x"), log=Path("y"),
                    launches=1, stats={"stages": s}) for s in stages_list]
    return run.Run(params={}, jobs=jobs, traced=1, trace=None, ref=None,
                   chunks=0, cold_s=1.0, device_kind="cpu")


def _read(metric, r):
    return spec.load_module(tiny.HOME / "metrics" / f"{metric}.py").read(r)


@pytest.mark.parametrize("stages", [_SHOT, _STREAM], ids=["shot", "stream"])
def test_coverage_tally_s_reads_each_jobs_part(stages):
    jobs = [_with_tally(stages, 0.02), _with_tally(stages, 0.06)]
    assert _read("coverage_tally_s", _run(jobs)) == pytest.approx(0.04)
    # A program without the part (the parent of the change that added it)
    # gives nothing and raises nothing.
    assert _read("coverage_tally_s", _run([stages, stages])) is None


@pytest.mark.parametrize("stages", [_SHOT, _STREAM], ids=["shot", "stream"])
def test_coverage_s_leaves_the_tally_part_out(stages):
    before = _read("coverage_s", _run([stages]))
    after = _read("coverage_s", _run([_with_tally(stages, 0.05)]))
    assert after == pytest.approx(before)
