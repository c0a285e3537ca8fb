"""Read load (``io/reads``, the C++ loader in ``native/``; host only):
the mean ``load`` span a job."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, names=("load",))
