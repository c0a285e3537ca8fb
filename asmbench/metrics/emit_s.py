"""Stage 4 (``graph/emit``, ``io/gfa``: device packs, then the GFA
rendered and written on the host): the mean ``stage4_emit`` or ``emit``
span a job."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, names=("stage4_emit", "emit"))
