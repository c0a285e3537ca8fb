"""Cells small enough for a test on the CPU."""

from __future__ import annotations

from pathlib import Path

from asmbench import spec

HOME = Path(__file__).resolve().parent.parent

SINGLE = {
    "genome": {"kind": "realistic", "length": 40000, "gc": 0.508, "seed": 3},
    "cli_args": ["-k", "32", "-m", str(1 << 22), "--membership", "bloom"],
    "params": {"k": 32, "short_k": 21, "cov_threshold": 2, "chunk_len": 1024,
               "filter_bits": 1 << 22, "hashes": 10, "membership": "bloom",
               "streaming": False},
    "reference": "debruijn",
}
STREAMING = {
    "genome": {"kind": "random", "length": 50000, "seed": 3},
    "cli_args": ["--streaming", "-k", "25", "--cov-threshold", "3",
                 "--chunk-len", "256", "--slice-chunks", "64",
                 "--membership", "bloom", "-m", str(1 << 22)],
    "params": {"k": 25, "short_k": 21, "cov_threshold": 3, "chunk_len": 256,
               "slice_chunks": 64, "filter_bits": 1 << 22, "hashes": 10,
               "membership": "bloom", "streaming": True},
    "reference": "debruijn",
}
# The HiFi mixes' profile, with reads cut to the tiny genomes.
TRAFFIC = {"coverage": 15, "read_len": 2500, "read_len_sd": 400,
           "min_read_len": 1000, "sub_rate": 0.0004, "ins_rate": 0.0008,
           "del_rate": 0.0008, "genome_salt": 1, "reads_salt": 2,
           "lengths_salt": 3}


def cell(config=SINGLE) -> spec.Cell:
    e2e = [{"name": n, "unit": "x"} for n in (
        "asm_mbases_per_s", "peak_device_gb", "setup_s")]
    layer = [{"name": n, "unit": "x"} for n in (
        "cold_job_s", "load_s", "stage1_s", "passes_s", "graph_s",
        "coverage_s", "emit_s", "bloom_set_bits_roofline",
        "device_idle_share")]
    return spec.Cell(workload={"name": "tiny.cell", "chips": 1},
                     config=config, traffic=TRAFFIC, end_to_end=e2e,
                     per_layer=layer, home=HOME)
