"""Stage 1 of single-shot assembly (``ops/kmer``, ``ops/count``,
``ops/windowmin``, ``ops/solid``): the mean ``stage1_count_solid`` span a
job."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, names=("stage1_count_solid",))
