"""``ops/coverage_tally`` and ``graph/coverage.CoverageTally`` on the CPU,
where stage 3 runs the plain chain: which inputs the kernel takes, what it
refuses before any launch, the bucket directory's lookups against
``count.lookup_id`` (padding rows, a table below its capacity, keys at
bucket boundaries, k = 32 keys with the top bit set), the running tally
over batches of chunks against one ``count_coverage`` call, and that no
run on the CPU launches the kernel while its part ``coverage.tally`` is
timed.  The kernel against the plain chain, on the card, is
``test_torch_coverage_tally_cuda.py``.
"""

import types

import numpy as np
import pytest
import torch

from platanus3_tpu_torch import pipeline as pipe
from platanus3_tpu_torch import sim
from platanus3_tpu_torch.config import AssemblyConfig
from platanus3_tpu_torch.graph import coverage as cov_mod
from platanus3_tpu_torch.io.reads import reads_from_strings
from platanus3_tpu_torch.ops import count as count_mod
from platanus3_tpu_torch.ops import coverage_tally as T
from platanus3_tpu_torch.ops import kmer as kmer_mod
from platanus3_tpu_torch.streaming import assemble_streaming

CHUNK_LEN = 64
FIELDS = ("packed", "valid_len", "start", "read_len", "prev_base",
          "next_base")


@pytest.mark.parametrize("is_cuda,k,kernel", [
    (True, 12, True), (True, 25, True), (True, 32, True),
    (True, 33, False), (True, 64, False),
    (False, 25, False), (False, 32, False), (False, 33, False)])
def test_kernel_rule(is_cuda, k, kernel):
    """The kernel runs on a CUDA tensor at k <= 32 (one 64-bit value a
    k-mer); the CPU and k > 32 keep the plain chain."""
    assert T.uses_kernel(types.SimpleNamespace(is_cuda=is_cuda), k) is kernel


@pytest.mark.parametrize("m,k,bits", [
    (1, 25, 1), (8, 25, 1), (1000, 25, 8), (1024, 25, 8), (1025, 25, 9),
    (5_242_880, 32, 21), (45_088_768, 25, 24), (1 << 20, 5, 10)])
def test_bucket_bits(m, k, bits):
    """About four node rows a bucket, at least one bit and at most 2k."""
    assert T.bucket_bits(m, k) == bits


def _lanes(values, k):
    """2k-bit values -> ``[N, L]`` int64 lanes."""
    v = np.asarray(values, dtype=np.uint64)
    if kmer_mod.num_lanes(k) == 1:
        return torch.from_numpy(v.astype(np.int64))[:, None]
    hi = (v >> np.uint64(32)).astype(np.int64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return torch.from_numpy(np.stack([hi, lo], axis=1))


def _boundary_values(k, cap, gen):
    """Random 2k-bit values, the values at, just below and just above
    bucket edges of a ``cap``-row directory, and at k = 32 values with the
    top bit set, the all-ones value among them."""
    top = 1 << (2 * k)
    shift = 2 * k - T.bucket_bits(cap, k)
    vals = {int(x) for x in gen.integers(0, top, 40, dtype=np.uint64)}
    for j in (1, 2, 3, (top >> shift) - 1):
        for d in (-1, 0, 1):
            vals.add((j << shift) + d)
    vals.add(0)
    vals.add(top - 1)
    if k == 32:
        vals |= {(1 << 63) + int(x) for x in
                 gen.integers(0, 1 << 62, 8, dtype=np.uint64)}
    return sorted(v for v in vals if 0 <= v < top)


@pytest.mark.parametrize("k", [5, 12, 16, 21, 25, 31, 32])
@pytest.mark.parametrize("cut", [0, 7], ids=["full", "below_capacity"])
def test_directory_lookup_equals_lookup_id(k, cut):
    """The directory's search finds every node at the row
    ``count.lookup_id`` gives, and -1 for the rest: rows past ``size``
    (padding, and keys cut off below the capacity) are no node."""
    gen = np.random.default_rng(1000 + k)
    cap = 256
    vals = _boundary_values(k, cap, gen)
    keys = count_mod.count_kmers(_lanes(vals, k), torch.ones(
        len(vals), dtype=torch.bool), k=k)
    size = int(keys.size) - cut
    nodes = pipe.pad_table_keys(keys.keys[:size], size, cap)
    table = count_mod.KmerTable(nodes, torch.zeros((cap,), dtype=torch.int64),
                                torch.tensor(size))
    index = T.node_index(nodes, table.size, k)
    assert index.offsets.dtype == torch.int32
    assert int(index.offsets[0]) == 0 and int(index.offsets[-1]) == size
    assert bool((index.offsets[1:] >= index.offsets[:-1]).all())
    near = [v + d for v in vals for d in (-1, 1)]
    queries = _lanes([v for v in vals + near if 0 <= v < 1 << (2 * k)], k)
    want = count_mod.lookup_id(table, queries)
    got = T.lookup_plain(index, queries)
    assert torch.equal(got, want)
    # Every node is found, and the keys cut off below the capacity are not.
    assert set(want[want >= 0].tolist()) == set(range(size))


def _graph_and_chunks(k, seed=7):
    genome = sim.random_genome(1500, seed=seed)
    reads = sim.simulate_reads(genome, coverage=6, read_len=200,
                               seed=seed + 1, sub_rate=0.01)
    # A tandem repeat gives junctions and, at even k, palindromes.
    reads.append("ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT" * 3)
    cfg = AssemblyConfig(k=k, chunk_len=CHUNK_LEN, log_path=None)
    res = pipe.assemble(reads, cfg, write_output=False, device="cpu")
    b = reads_from_strings(reads, k, CHUNK_LEN)
    cols = [torch.from_numpy(getattr(b, f).astype(np.int64)) for f in FIELDS]
    return res.dbg, cols


@pytest.mark.parametrize("k", [21, 32])
@pytest.mark.parametrize("with_nid", [False, True], ids=["lookup", "nid"])
def test_running_tally_equals_one_call(k, with_nid):
    """Batches of chunks added into one ``CoverageTally`` sum to
    ``count_coverage`` over all the chunks, with stage 1's ids given or
    looked up, and launch nothing on the CPU."""
    dbg, cols = _graph_and_chunks(k)
    packed, vlen, start, rlen, pb, nb = cols
    bases = kmer_mod.unpack_bases(packed)
    nid = None
    if with_nid:
        fw, _ = kmer_mod.extract_kmers(bases, vlen, k)
        canon, _ = kmer_mod.canonical(fw, k)
        table = count_mod.KmerTable(dbg.nodes, dbg.nodes[:, 0], dbg.size)
        nid = count_mod.lookup_id(table, canon.reshape(-1, canon.shape[-1])
                                  ).reshape(canon.shape[:2])
        # The directory finds the same ids.
        index = T.node_index(dbg.nodes, dbg.size, k)
        assert torch.equal(T.lookup_plain(
            index, canon.reshape(-1, canon.shape[-1])), nid.reshape(-1))
    want = cov_mod.count_coverage(dbg, k, bases, vlen, start, rlen, pb, nb,
                                  nid=nid)
    assert int(want.jun_tally.sum()) > 0 and int(want.node_cov.sum()) > 0
    before = T.coverage_tally.kernel_launches
    tally = cov_mod.CoverageTally(dbg, k)
    c = packed.shape[0]
    for lo, hi in ((0, 5), (5, c // 2), (c // 2, c)):
        tally.add(*(x[lo:hi] for x in cols),
                  nid=None if nid is None else nid[lo:hi])
    got = tally.result()
    assert torch.equal(got.node_cov, want.node_cov)
    assert torch.equal(got.jun_tally, want.jun_tally)
    assert T.coverage_tally.kernel_launches == before


def test_empty_tally_is_zero():
    """A pass over no chunk gives zero tallies of the graph's size."""
    dbg, _ = _graph_and_chunks(21)
    got = cov_mod.CoverageTally(dbg, 21).result()
    m = dbg.nodes.shape[0]
    assert got.node_cov.shape == (m,) and got.jun_tally.shape == (m * 8,)
    assert int(got.node_cov.abs().sum()) == int(got.jun_tally.abs().sum()) == 0


@pytest.mark.parametrize("case", ["k33", "dtype", "nid_shape", "no_index",
                                  "is_jun", "tally_shape", "offsets"])
def test_kernel_refuses_before_launch(case):
    """What the kernel does not take raises ``ValueError`` before the
    library is built or anything is launched."""
    k, c, words, m = 25, 4, CHUNK_LEN // 16, 64
    packed = torch.zeros((c, words), dtype=torch.int64)
    arrays = [torch.zeros((c,), dtype=torch.int64) for _ in range(5)]
    node_cov = torch.zeros((m,), dtype=torch.int64)
    jun_tally = torch.zeros((m * 8,), dtype=torch.int64)
    is_jun = torch.zeros((m,), dtype=torch.bool)
    nid = torch.zeros((c, CHUNK_LEN - k + 1), dtype=torch.int64)
    index = None
    if case == "k33":
        k = 33
    elif case == "dtype":
        arrays[0] = arrays[0].int()
    elif case == "nid_shape":
        nid = nid[:, 1:]
    elif case == "no_index":
        nid = None
    elif case == "is_jun":
        is_jun = is_jun.long()
    elif case == "offsets":
        keys = torch.full((m, 2), kmer_mod.MASK32, dtype=torch.int64)
        nid, index = None, T.node_index(keys, 0, k)
        index = index._replace(offsets=index.offsets[:-1])
    else:
        jun_tally = jun_tally[1:]
    before = T.coverage_tally.kernel_launches
    with pytest.raises(ValueError):
        T.coverage_tally(node_cov, jun_tally, packed, *arrays, k=k,
                         is_jun=is_jun, nid=nid, index=index)
    assert T.coverage_tally.kernel_launches == before


@pytest.mark.parametrize("k,streaming", [(25, True), (21, False),
                                         (33, False)])
def test_cpu_runs_time_the_tally_and_launch_nothing(k, streaming):
    """A run on the CPU times stage 3's tally as the part
    ``coverage.tally`` of its span, and ``coverage_tally_launches`` reads
    0 (the CPU and k > 32 run the plain chain)."""
    genome = sim.random_genome(2000, seed=61)
    reads = sim.simulate_reads(genome, coverage=10, read_len=300, seed=62,
                               sub_rate=0.01)
    cfg = AssemblyConfig(k=k, chunk_len=128, log_path=None,
                         profile_stages=True)
    if streaming:
        res = assemble_streaming(reads, cfg, write_output=False,
                                 slice_chunks=8, device="cpu")
        span = "coverage"
    else:
        res = pipe.assemble(reads, cfg, write_output=False, device="cpu")
        span = "stage3_coverage"
    stages = res.stats["stages"]
    assert "coverage.tally" in stages and span in stages
    assert 0 <= stages["coverage.tally"] <= stages[span]
    assert res.stats["counts"]["coverage_tally_launches"] == 0
    assert res.stats["span_counts"]["coverage.tally"][
        "coverage_tally_launches"] == 0
