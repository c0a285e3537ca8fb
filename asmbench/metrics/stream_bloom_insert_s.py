"""Streaming pass 2's Bloom insert (``ops/partitioned.solid_collect_slice``
-> ``bloom_add``, one ``bloom_set_bits`` launch a slice): the mean sum a
job of its part ``pass2.bloom_insert``, over the job's slices; None where
the program times no such part."""

from asmbench.spans import mean_span


def read(run):
    return mean_span(run, names=("pass2.bloom_insert",))
