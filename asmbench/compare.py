"""The comparison that decides ``correct``: every window job's GFA and
solid-node count against the plain reference's, exactly.

Each number compared has the limit 0, since the assembly is integer
arithmetic throughout: a job is right only if its GFA is the reference's
byte for byte.
"""

from __future__ import annotations

from collections import Counter

__all__ = ["line_diff", "checks", "LIMITS"]

LIMITS = {"jobs_differ": 0, "lines_differ": 0, "straights_differ": 0,
          "junctions_differ": 0, "links_differ": 0, "solid_nodes_differ": 0}


def _kind(line: str) -> str:
    if line.startswith("S\tStraight_"):
        return "straights_differ"
    if line.startswith("S\tJunction_"):
        return "junctions_differ"
    if line.startswith("L\t"):
        return "links_differ"
    return "lines_differ"


def line_diff(got: str, want: str) -> dict:
    """Lines of each kind in one text and not the other (as multisets),
    and all of them under ``lines_differ``."""
    d = Counter(got.splitlines())
    d.subtract(Counter(want.splitlines()))
    out = {"lines_differ": 0, "straights_differ": 0, "junctions_differ": 0,
           "links_differ": 0}
    for line, n in d.items():
        if n:
            out[_kind(line)] += abs(n)
            if _kind(line) != "lines_differ":
                out["lines_differ"] += abs(n)
    return out


def checks(answers, ref) -> dict:
    """``answers``: each window job's ``(gfa text or None, solid nodes or
    None)``; ``ref``: the reference's ``Assembly``.  Returns each number
    compared with its limit; for the line counts, the job that differs
    most."""
    out = {name: 0 for name in LIMITS}
    for gfa, solid in answers:
        if gfa == ref.gfa and solid == ref.solid_nodes:
            continue
        out["jobs_differ"] += 1
        diff = line_diff(gfa or "", ref.gfa)
        for name, n in diff.items():
            out[name] = max(out[name], n)
        out["solid_nodes_differ"] = max(
            out["solid_nodes_differ"],
            abs((solid if solid is not None else 0) - ref.solid_nodes))
    return {name: {"value": v, "limit": LIMITS[name]}
            for name, v in out.items()}
