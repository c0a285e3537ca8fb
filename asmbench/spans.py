"""Means of the program's stage spans over a run's jobs.

A job run with ``--profile-stages`` logs one ``stats`` line whose
``stages`` map each stage to the seconds it took, the device
synchronised at each boundary.
"""

from __future__ import annotations

__all__ = ["mean_span"]


def mean_span(run, names=(), prefixes=()):
    """The mean over the window's jobs of the summed spans named in
    ``names`` or starting with one of ``prefixes``; None where a job has
    none of them."""
    per_job = []
    for job in run.jobs:
        stages = (job.stats or {}).get("stages", {})
        keys = [n for n in stages if n in names or n.startswith(
            tuple(prefixes))]
        if not keys:
            return None
        per_job.append(sum(stages[n] for n in keys))
    return sum(per_job) / len(per_job) if per_job else None
