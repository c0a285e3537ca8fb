"""Stage 2's Bloom queries (``graph/build._neighbor_info`` ->
``bloom_query`` over the 8 neighbour columns of every node): the mean sum
a job of its part ``graph.bloom_query``; None where the program times no
such part."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, names=("graph.bloom_query",))
