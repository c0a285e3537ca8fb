"""``bloom_set_bits`` (``ops/bloom``, ``csrc/bloom.cu``) against its
roofline, in percent: the least time of the traced jobs' launches (their
bytes, ``yardstick.bloom_set_bits_bytes``, at the device's memory
bandwidth) over the device time of the kernels of its passes (partition
count, scatter and refine of the Bloom rows, then the region OR)."""

from asmbench import yardstick

_PASSES = ("BloomRows", "PackedRows", "BloomRefine")


def is_pass(kernel: str) -> bool:
    return "bloom_region_or_kernel" in kernel or (
        "partition_" in kernel and any(p in kernel for p in _PASSES))


def read(run):
    if run.trace is None:
        return None
    seconds = sum(s for name, s in run.trace.kernels.items() if is_pass(name))
    jobs = run.jobs[:run.traced]
    peaks = yardstick.peaks_of(run.device_kind)
    if seconds <= 0 or peaks is None or not any(j.launches for j in jobs):
        return None
    least = sum(yardstick.bloom_set_bits_bytes(
        run.params, j.launches, run.ref.solid_nodes, run.ref.solid_positions,
        run.chunks) for j in jobs) / peaks["hbm_bytes_per_s"]
    return 100.0 * least / seconds
