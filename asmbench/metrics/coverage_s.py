"""Stage 3 (``graph/coverage``, ``reach``, ``sequence``): the mean
``stage3_coverage`` span a single-shot job, ``coverage`` + ``reach_chars``
a streaming one."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, names=("stage3_coverage", "coverage",
                                 "reach_chars"))
