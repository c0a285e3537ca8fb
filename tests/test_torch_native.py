"""The port's C++ read loader against its numpy loader and the JAX
package's loader: every ``ReadBatch`` array equal, over FASTA and FASTQ,
wrapped and unwrapped lines (the cases of ``tests/test_native.py``); and
the loader raises, never falls back, when it cannot build or read.
"""

import numpy as np
import pytest

from platanus3_tpu.io import reads as j_reads
from platanus3_tpu_torch import native
from platanus3_tpu_torch.io import reads as t_reads

RNG = np.random.default_rng(61)
FIELDS = ("packed", "valid_len", "read_id", "start", "read_len",
          "prev_base", "next_base")


def write_fasta(path, seqs, wrap=0):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">read{i} extra header stuff\n")
            if wrap:
                for j in range(0, len(s), wrap):
                    f.write(s[j:j + wrap] + "\n")
            else:
                f.write(s + "\n")


def write_fastq(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@read{i}\n{s}\n+\n{'I' * len(s)}\n")


def random_seqs(n, lo, hi):
    return ["".join(RNG.choice(list("ACGT"), size=int(RNG.integers(lo, hi))))
            for _ in range(n)]


def assert_batches_equal(a, b):
    assert (a.num_reads, a.all_bases, a.chunk_len, a.k) == \
        (b.num_reads, b.all_bases, b.chunk_len, b.k)
    for field in FIELDS:
        assert np.array_equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("fmt,wrap", [("fasta", 0), ("fasta", 60),
                                      ("fastq", 0)])
def test_native_equals_numpy_and_jax(tmp_path, fmt, wrap):
    seqs = random_seqs(30, 30, 700)
    seqs += ["ACGT" * 3]            # shorter than k: dropped
    seqs += ["acgtNNNacgt" * 10]    # lowercase and N: coded 0
    path = str(tmp_path / f"reads.{fmt}")
    if fmt == "fasta":
        write_fasta(path, seqs, wrap)
    else:
        write_fastq(path, seqs)
    k, chunk_len = 25, 256
    nat = t_reads.load_reads(path, k, chunk_len)
    assert_batches_equal(nat, t_reads.load_reads(path, k, chunk_len,
                                                 use_native=False))
    assert_batches_equal(nat, j_reads.load_reads(path, k, chunk_len))
    assert nat.num_reads == 31
    assert native.library_path().exists()


def test_native_raises_when_the_build_fails(tmp_path, monkeypatch):
    path = tmp_path / "r.fasta"
    write_fasta(path, random_seqs(3, 40, 80))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    bad = tmp_path / "packer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    with pytest.raises(RuntimeError, match="native loader build failed"):
        t_reads.load_reads(str(path), 25, 256)


@pytest.mark.parametrize("content", [None, "", "ACGT\n"])
def test_native_raises_on_unreadable_input(tmp_path, content):
    path = tmp_path / "r.fasta"
    if content is not None:
        path.write_text(content)
    with pytest.raises(OSError, match="native loader could not read"):
        t_reads.load_reads(str(path), 25, 256)


def test_extension_is_checked_first(tmp_path):
    path = tmp_path / "r.txt"
    path.write_text(">a\nACGT\n")
    with pytest.raises(ValueError, match="fasta"):
        t_reads.load_reads(str(path), 25, 256)
