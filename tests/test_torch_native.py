"""The port's C++ read loader against its numpy loader and the JAX
package's loader: every ``ReadBatch`` array equal, over FASTA and FASTQ,
wrapped and unwrapped lines (the cases of ``tests/test_native.py``),
blank lines, a missing last newline, an empty last record, FASTQ quality
lines that start with a record marker, reads of k and k - 1 bases, reads
that end on a chunk's end, and any thread count; a profiled job times
the loader's parts; and the loader raises, never falls back, when it
cannot build or read.
"""

import numpy as np
import pytest

from platanus3_tpu.io import reads as j_reads
from platanus3_tpu_torch import native
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.io import reads as t_reads
from platanus3_tpu_torch.pipeline import assemble
from platanus3_tpu_torch.streaming import assemble_streaming

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


def fasta_text(records):
    """FASTA text of ``(sequence, wrap)`` records: one line of sequence
    where ``wrap`` is 0, else lines of ``wrap`` bases."""
    out = []
    for i, (s, wrap) in enumerate(records):
        out.append(f">read{i} extra header stuff\n")
        step = wrap or max(len(s), 1)
        out += [s[j:j + step] + "\n" for j in range(0, len(s), step)]
    return "".join(out)


K, CHUNK_LEN = 25, 256
STRIDE = CHUNK_LEN - K + 1


def case_text(case, seqs):
    """The file text of one case of ``test_native_equals_numpy_and_jax``
    (its format is the case's first word)."""
    if case.startswith("fasta-wrap"):
        return fasta_text([(s, int(case.split("-")[-1])) for s in seqs])
    if case == "fasta-blank-lines":     # inside and between records
        return "".join(f">r{i}\n\n{s[:50]}\n\n{s[50:]}\n\n"
                       if i % 2 else f">r{i}\n{s}\n\n\n"
                       for i, s in enumerate(seqs))
    if case == "fasta-no-trailing-newline":
        return fasta_text([(s, 0) for s in seqs])[:-1]
    if case == "fasta-empty-last-record":
        return fasta_text([(s, 0) for s in seqs]) + ">no sequence"
    if case == "fasta-k-and-k-minus-1":
        return fasta_text([(s[:K - i % 2], 0) for i, s in enumerate(seqs)]
                          + [(s, 0) for s in seqs])
    if case == "fasta-chunk-boundary":  # the last chunk ends on the read's end
        return fasta_text([(s[:CHUNK_LEN + (i % 3) * STRIDE], 0)
                           for i, s in enumerate(seqs)])
    if case == "fasta-mixed-lines":
        return fasta_text([(s, (0, 61, 7)[i % 3]) for i, s in enumerate(seqs)])
    if case == "fastq-quality-markers":  # quality lines start with @ or +
        return "".join(f"@read{i}\n{s}\n+\n{'@+'[i % 2]}{'I' * (len(s) - 1)}\n"
                       for i, s in enumerate(seqs))
    raise ValueError(case)


LEGACY_CASES = [pytest.param("fasta", 0, None, id="fasta-0"),
                pytest.param("fasta", 60, None, id="fasta-60"),
                pytest.param("fastq", 0, None, id="fastq-0")]
EDGE_CASES = ["fasta-wrap-1", "fasta-wrap-61", "fasta-wrap-4097",
              "fasta-blank-lines", "fasta-no-trailing-newline",
              "fasta-empty-last-record", "fasta-k-and-k-minus-1",
              "fasta-chunk-boundary", "fasta-mixed-lines",
              "fastq-quality-markers"]


@pytest.mark.parametrize("fmt,wrap,case", LEGACY_CASES + [
    pytest.param(c.split("-")[0], 0, c, id=c) for c in EDGE_CASES])
def test_native_equals_numpy_and_jax(tmp_path, fmt, wrap, case):
    seqs = random_seqs(30, 30, 700)
    seqs += ["ACGT" * 3]            # shorter than k: dropped
    seqs += ["acgtNNNacgt" * 10]    # lowercase and N: coded 0
    path = str(tmp_path / f"reads.{fmt}")
    if case is not None:
        if case == "fasta-wrap-4097":
            seqs += random_seqs(3, 4097, 9000)
        if case == "fasta-chunk-boundary":
            seqs = random_seqs(9, 2 * CHUNK_LEN + 3, 800)
        with open(path, "w") as f:
            f.write(case_text(case, seqs))
    elif fmt == "fasta":
        write_fasta(path, seqs, wrap)
    else:
        write_fastq(path, seqs)
    nat = t_reads.load_reads(path, K, CHUNK_LEN)
    assert_batches_equal(nat, t_reads.load_reads(path, K, CHUNK_LEN,
                                                 use_native=False))
    assert_batches_equal(nat, j_reads.load_reads(path, K, CHUNK_LEN))
    if case is None:
        assert nat.num_reads == 31
    assert nat.num_reads > 0
    assert native.library_path().exists()


@pytest.mark.parametrize("threads", [1, 8, 100])
def test_native_equal_on_any_thread_count(tmp_path, threads):
    """The reads split between threads by the rows they pack; 100 threads
    are more than the 33 reads."""
    seqs = random_seqs(30, 30, 1500) + random_seqs(3, 4000, 6000)
    path = str(tmp_path / "reads.fasta")
    with open(path, "w") as f:
        f.write(case_text("fasta-mixed-lines", seqs))
    nat = native.load_reads_native(path, K, CHUNK_LEN, threads=threads)
    assert nat.num_reads == len(seqs) < 100
    assert_batches_equal(nat, t_reads.load_reads(path, K, CHUNK_LEN,
                                                 use_native=False))


@pytest.mark.parametrize("wrap", [0, 20])
@pytest.mark.parametrize("entry", [assemble, assemble_streaming])
def test_profiled_job_times_the_load_parts(tmp_path, entry, wrap):
    """Under ``profile_stages`` a job from a file times parts
    ``load.parse`` and ``load.pack`` inside span ``load`` and counts the
    reads packed straight from the mapped text: all of a one-line FASTA,
    none of one wrapped at 20 bases (every read is longer)."""
    genome = "".join(RNG.choice(list("ACGT"), size=300))
    seqs = [genome[i:i + 60] for i in range(0, 240, 30)] * 2
    path = tmp_path / "reads.fasta"
    write_fasta(path, seqs, wrap)
    cfg = TConfig(k=25, chunk_len=256, log_path=None, profile_stages=True)
    stats = entry(str(path), cfg, write_output=False, device="cpu").stats
    names = list(stats["stages"])
    at = names.index("load")
    assert names[at + 1:at + 3] == ["load.parse", "load.pack"]
    assert "." not in names[at + 3]
    stages = stats["stages"]
    assert stages["load.parse"] + stages["load.pack"] <= stages["load"]
    assert stats["counts"]["load_direct_reads"] == (0 if wrap else len(seqs))


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
