"""Stage 3's coverage tally (``graph/coverage.CoverageTally``: on the card
one ``coverage_tally`` launch a batch of chunks, the single shot's one or
a streaming slice): the mean sum a job of the part ``coverage.tally``, over
the job's slices and coverage passes; None where the program times no such
part."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, names=("coverage.tally",))
