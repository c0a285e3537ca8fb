"""Stage 2 (``graph/build``, the Bloom build and closure): the mean
``bloom_build`` + ``stage2_graph`` spans a single-shot job, ``graph`` a
streaming one."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, names=("bloom_build", "stage2_graph", "graph"))
