"""``ops/slice_kmers`` on the CPU, where the slice passes run the plain
chain: which inputs the kernel takes, what it refuses before any launch,
that a mode's histogram is the count of its collect's rows, and that no
run on the CPU launches the kernel.  The plain chain against the JAX
package is ``test_torch_partitioned.py``; the kernel against the plain
chain, on the card, ``test_torch_slice_kmers_cuda.py``.
"""

import types

import numpy as np
import pytest
import torch

from platanus3_tpu_torch import sim
from platanus3_tpu_torch.config import AssemblyConfig
from platanus3_tpu_torch.io.reads import reads_from_strings
from platanus3_tpu_torch.ops import slice_kmers as SK
from platanus3_tpu_torch.streaming import assemble_streaming

CHUNK_LEN, SLICE, PARTS, THRESHOLD = 256, 8, 16, 2
FIELDS = ("packed", "valid_len", "start", "read_len")


def slice_arrays(k, lo=SLICE, hi=2 * SLICE):
    genome = sim.random_genome(3000, seed=51)
    reads = sim.simulate_reads(genome, coverage=8, read_len=400, seed=52,
                               sub_rate=0.01)
    b = reads_from_strings(reads, k, CHUNK_LEN)
    return [torch.from_numpy(getattr(b, f)[lo:hi].astype(np.int64))
            for f in FIELDS]


@pytest.mark.parametrize("is_cuda,k,kernel", [
    (True, 16, True), (True, 25, True), (True, 32, True),
    (True, 33, False), (True, 64, False),
    (False, 25, False), (False, 33, False)])
def test_kernel_rule(is_cuda, k, kernel):
    """The kernel runs on a CUDA tensor at k <= 32 (one order-key word);
    the CPU and k > 32 keep the plain chain."""
    assert SK.uses_kernel(types.SimpleNamespace(is_cuda=is_cuda), k) is kernel


@pytest.mark.parametrize("case", ["k33", "parts", "counts", "chunks"])
def test_kernel_refuses_before_launch(case):
    """What the kernel does not take raises ``ValueError`` before the
    library is built or anything is launched."""
    packed, vlen, start, rlen = slice_arrays(25)
    counts = torch.zeros((4 * SLICE * CHUNK_LEN,), dtype=torch.int32)
    kw = dict(k=25, short_k=21, cov_threshold=THRESHOLD, parts=PARTS)
    if case == "k33":
        kw["k"] = 33
    elif case == "parts":
        kw["parts"] = 12
    elif case == "counts":
        counts = counts.long()
    else:
        vlen = vlen[1:]
    before = SK.slice_kmers.kernel_launches
    with pytest.raises(ValueError):
        SK.slice_kmers(3, packed, vlen, start, rlen, counts, 0, **kw)
    assert SK.slice_kmers.kernel_launches == before


@pytest.mark.parametrize("short_k,k", [(21, 25), (21, 32), (15, 17),
                                       (21, 33)])
@pytest.mark.parametrize("solid", [False, True], ids=["short", "solid"])
def test_histogram_counts_collected_rows(short_k, k, solid):
    """On the CPU the entry points give the plain chain's arrays, and a
    pass's histogram counts the rows its collect sends to each
    partition."""
    arrays = slice_arrays(k)
    p_short = CHUNK_LEN - short_k + 1
    posbase = SLICE * p_short
    gen = np.random.default_rng(53)
    counts = torch.from_numpy(gen.integers(
        0, 2 * THRESHOLD + 1, 3 * SLICE * p_short, dtype=np.int32))
    before = SK.slice_kmers.kernel_launches
    outs = []
    for collect in (False, True):
        if solid:
            kw = dict(k=k, short_k=short_k, cov_threshold=THRESHOLD,
                      parts=PARTS, collect=collect)
            got = SK.solid_slice(counts, *arrays, posbase, **kw)
            want = SK.solid_slice_plain(counts, *arrays, posbase, **kw)
        else:
            kw = dict(k=k, short_k=short_k, parts=PARTS, collect=collect)
            got = SK.short_slice(*arrays, posbase, **kw)
            want = SK.short_slice_plain(*arrays, posbase, **kw)
        got, want = ((got,), (want,)) if not collect else (got, want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        outs.append(got)
    assert SK.slice_kmers.kernel_launches == before
    (hist,), rows = outs
    part = rows[1] if solid else rows[2]
    assert torch.equal(hist, SK.part_counts(part, PARTS))
    assert int(hist.sum()) > 0
    words = (((k if solid else short_k) + 15) // 16 + 1) // 2
    assert rows[0].shape == (part.shape[0], words)
    if solid:
        chunk_min, chunk_fw = rows[2], rows[3]
        has = chunk_min < SK.NO_SEED
        assert bool(has.any())
        assert bool((chunk_fw[~has] == 0).all())


@pytest.mark.parametrize("k", [25, 33])
def test_no_kernel_launch_on_the_cpu(k):
    """A streaming run on the CPU reads every slice through the plain
    chain: its ``slice_kmers_launches`` counter stays 0."""
    genome = sim.random_genome(3000, seed=54)
    reads = sim.simulate_reads(genome, coverage=10, read_len=400, seed=55,
                               sub_rate=0.01)
    cfg = AssemblyConfig(k=k, chunk_len=CHUNK_LEN, log_path=None,
                         profile_stages=True)
    before = SK.slice_kmers.kernel_launches
    res = assemble_streaming(reads, cfg, write_output=False,
                             slice_chunks=SLICE, device="cpu")
    assert res.stats["counts"]["slice_kmers_launches"] == 0
    assert SK.slice_kmers.kernel_launches == before
    assert res.stats["solid_nodes"] > 0
