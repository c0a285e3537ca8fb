"""What a ``torch.profiler`` Chrome trace of the traced jobs says.

The arithmetic of ``chip_smoke.trace_summary``: the traced window is the
host annotation the harness opens around the traced jobs; the device is
busy in the union of its kernel, copy and set intervals inside it; the
rest is idle.  Each idle gap is named by the job stage it falls in (from
the stage spans of that job, laid from its start) and by the outermost
host event that overlaps it, ``host`` where there is none.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

__all__ = ["TraceSummary", "summarize", "union", "WINDOW", "JOB"]

WINDOW = "asmbench.traced_jobs"
JOB = "asmbench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function",
             "cuda_runtime", "cuda_driver")
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict           # kernel name -> seconds on the device
    gaps: list              # [(name, seconds)], longest first, at most TOP
    device_events: int


def union(intervals, lo: float, hi: float):
    """Merged intervals of ``intervals`` clipped to ``[lo, hi]``."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _stage_at(t, jobs, job_spans):
    """The stage span of the job running at trace time ``t`` (us)."""
    for (start, end), spans in zip(jobs, job_spans):
        if start <= t <= end:
            at = start
            for name, s in spans.items():
                at += s * 1e6
                if t <= at:
                    return name
            return None
    return None


def _host_name(lo, hi, host):
    best, best_dur = None, -1.0
    for ts, te, name in host:
        if ts >= hi:
            break
        if te > lo and te - ts > best_dur:
            best, best_dur = name, te - ts
    return best or "host"


def summarize(path: Path, job_spans=()) -> TraceSummary:
    """Summary of the trace at ``path``; ``job_spans`` gives each traced
    job's stage spans (s), in order, to name the idle gaps."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
    (window,) = [e for e in events if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
    lo = float(window["ts"])
    hi = lo + float(window["dur"])
    device = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in events if e.get("cat") in DEVICE_CATS]
    busy = union(device, lo, hi)
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel" and lo <= float(e["ts"]) <= hi:
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + float(
                e.get("dur", 0)) / 1e6
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    jobs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("name") == JOB
                  and e.get("cat") == "user_annotation")
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("cat") in HOST_CATS
                  and not e["name"].startswith("asmbench."))
    named = []
    for dur, a, b in gaps:
        stage = _stage_at((a + b) / 2, jobs, list(job_spans))
        what = _host_name(a, b, host)
        named.append((f"{stage}:{what}" if stage else what, dur / 1e6))
    return TraceSummary(window_s=(hi - lo) / 1e6,
                        busy_s=sum(b - a for a, b in busy) / 1e6,
                        kernels=kernels, gaps=named,
                        device_events=len(device))
