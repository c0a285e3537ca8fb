"""Streaming's ``bloom_set_bits`` launches (``ops/bloom``,
``csrc/bloom.cu``; one a slice, over the slice's rows) against their
roofline, in percent, read as ``bloom_set_bits_roofline`` reads the
single-shot launch; None in a single-shot cell.  The least bytes,
``yardstick.bloom_set_bits_bytes``, count for a launch its slice's row
mask, the lanes of the solid rows it lets in, and the whole filter read
and written."""

from pathlib import Path

from asmbench.spec import load_module

_SHOT = load_module(Path(__file__).with_name("bloom_set_bits_roofline.py"))


def read(run):
    if not run.params.get("streaming"):
        return None
    return _SHOT.read(run)
