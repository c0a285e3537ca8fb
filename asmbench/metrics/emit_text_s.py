"""Stage 4's host text (``io/gfa``: ``sequences_from_pack`` and
``gfa_lines``) and the GFA file's write: the mean ``emit.text`` +
``emit.write`` parts a job, with no device work in them."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, names=("emit.text", "emit.write"))
