"""Streaming passes 1 and 2 (``streaming``, ``ops/partitioned``): the mean
sum of the ``pass1_*`` and ``pass2_*`` spans a job."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, prefixes=("pass1_", "pass2_"))
