"""The ``coverage_tally`` kernel against the plain chain, on the card.

Chunks of random bases are tallied through ``graph/coverage.CoverageTally``
(the kernel, in two launches that add into the same running tallies) and
through the plain ``count_coverage`` on the same card, with stage 1's ids
given and looked up through the bucket directory, at k = 21, 25, 31 and
32; ``node_cov`` and ``jun_tally`` must be array-equal.  The chunks hold
planted palindromes (even k), k-mers whose keys sit at the directory's
bucket edges and, at k = 32, keys with the top bit set; a padding chunk,
a chunk shorter than k and reads' ends; the node table is
junction-dense and its ``size`` below its capacity.  Then single-shot
runs (stage 1's ids, and the Bloom closure's lookups) and a streaming run
on the card give the same GFA through the kernel and through the plain
chain (the dispatch monkeypatched), with one launch a coverage pass's
batch.

They skip where ``torch.cuda.is_available()`` is false.  This file imports
neither JAX nor the JAX package, so on a machine with a card and without
JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_coverage_tally_cuda.py
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

pytestmark = pytest.mark.cuda

CHUNK_LEN, CHUNKS, READ_CHUNKS = 256, 48, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _value(codes):
    v = 0
    for b in codes:
        v = (v << 2) | int(b)
    return v


def _codes(v, k):
    return [(v >> (2 * (k - 1 - i))) & 3 for i in range(k)]


def _planted(k, cap, gen):
    """k-mers (base codes) to plant: palindromes at even k, the canonical
    forms of values at the directory's bucket edges, and at k = 32 k-mers
    whose canonical form has the top bit set (first base G or T, last A
    or C, so that both orientations start with G or T)."""
    out = []
    if k % 2 == 0:
        for _ in range(6):
            half = list(gen.integers(0, 4, k // 2))
            out.append(half + [3 - b for b in reversed(half)])
    shift = 2 * k - T.bucket_bits(cap, k)
    for j in (1, 5, (1 << (2 * k - shift)) - 1):
        for d in (-1, 0, 1):
            v = (j << shift) + d
            if 0 <= v < 1 << (2 * k):
                out.append(_codes(v, k))
    if k == 32:
        for _ in range(6):
            mid = list(gen.integers(0, 4, k - 2))
            out.append([int(gen.integers(2, 4))] + mid
                       + [int(gen.integers(0, 2))])
    return out


def chunk_case(k, device, seed):
    """Random chunks with planted k-mers, in reads of three chunks (the
    last with a tail), a padding chunk and a chunk of k - 1 valid bases;
    bases before and after chunks, 4 at reads' ends."""
    gen = np.random.default_rng(seed)
    bases = gen.integers(0, 4, (CHUNKS, CHUNK_LEN))
    cap = 1 << 14
    for n, kmer in enumerate(_planted(k, cap, gen)):
        c, p = 1 + n % (CHUNKS - 2), int(gen.integers(0, CHUNK_LEN - k))
        bases[c, p:p + k] = kmer
    stride = CHUNK_LEN - k + 1
    nth = np.arange(CHUNKS) % READ_CHUNKS
    start = nth * stride
    rlen = np.full(CHUNKS, (READ_CHUNKS - 1) * stride + CHUNK_LEN // 2)
    vlen = np.minimum(rlen - start, CHUNK_LEN)
    vlen[7] = 0              # a padding chunk, as a mesh rank's block
    vlen[11] = k - 1         # a chunk shorter than k
    prev = np.where(nth == 0, 4, gen.integers(0, 4, CHUNKS))
    nxt = np.where(nth == READ_CHUNKS - 1, 4, gen.integers(0, 4, CHUNKS))
    packed = kmer_mod.pack_bases_np(bases.astype(np.uint8)).astype(np.int64)
    cols = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(
        device) for a in (packed, vlen, start, rlen, prev, nxt)]
    return cols, cap


def graph_case(cols, k, cap, seed):
    """A junction-dense node table: the canonical k-mers of about 60 % of
    the chunks' positions (every planted one among them) and random keys,
    ``size`` below the capacity ``cap``, 40 % of the nodes junctions."""
    gen = torch.Generator(device=cols[0].device).manual_seed(seed)
    fw, _ = kmer_mod.extract_kmers(kmer_mod.unpack_bases(cols[0]), cols[1], k)
    canon, _ = kmer_mod.canonical(fw, k)
    lanes = canon.reshape(-1, canon.shape[-1])
    keep = torch.rand(lanes.shape[0], generator=gen,
                      device=lanes.device) < 0.6
    keep[::97] = True
    extra = torch.randint(0, 1 << 32, (2000, lanes.shape[1]), generator=gen,
                          device=lanes.device, dtype=torch.int64)
    extra[:, 0] &= kmer_mod._top_mask(k)
    rows = torch.cat([lanes[keep], kmer_mod.canonical(extra, k)[0]])
    table = count_mod.count_kmers(rows, torch.ones(
        rows.shape[0], dtype=torch.bool, device=rows.device), k=k)
    size = int(table.size)
    assert size < cap
    nodes = pipe.pad_table_keys(table.keys[:size], size, cap)
    is_jun = torch.rand(cap, generator=gen, device=nodes.device) < 0.4
    dbg = types.SimpleNamespace(nodes=nodes, size=torch.tensor(
        size, device=nodes.device), is_junction_final=is_jun)
    nid = count_mod.lookup_id(
        count_mod.KmerTable(nodes, nodes[:, 0], dbg.size),
        lanes).reshape(canon.shape[:2])
    pal = kmer_mod.is_palindrome(canon, k)
    return dbg, nid, int(pal.sum())


@pytest.mark.parametrize("k", [21, 25, 31, 32])
@pytest.mark.parametrize("with_nid", [False, True], ids=["lookup", "nid"])
def test_kernel_matches_plain(cuda, k, with_nid):
    cols, cap = chunk_case(k, cuda, seed=100 + k)
    dbg, nid, pals = graph_case(cols, k, cap, seed=200 + k)
    assert pals > 0 or k % 2
    want = cov_mod.count_coverage(dbg, k, kmer_mod.unpack_bases(cols[0]),
                                  *cols[1:], nid=nid if with_nid else None)
    before = T.coverage_tally.kernel_launches
    tally = cov_mod.CoverageTally(dbg, k)
    half = CHUNKS // 2
    for lo, hi in ((0, half), (half, CHUNKS)):
        tally.add(*(x[lo:hi] for x in cols),
                  nid=nid[lo:hi].contiguous() if with_nid else None)
    got = tally.result()
    torch.cuda.synchronize()
    assert T.coverage_tally.kernel_launches == before + 2
    assert got.node_cov.dtype == got.jun_tally.dtype == torch.int64
    assert torch.equal(got.node_cov, want.node_cov)
    assert torch.equal(got.jun_tally, want.jun_tally)
    assert int((want.node_cov == 2).sum()) > 0 or k % 2
    assert int(want.jun_tally.sum()) > 0


def test_directory_lookup_on_the_card(cuda):
    """The directory built on the card finds the ids ``lookup_id`` gives
    for every position, at a table of 2^20 rows."""
    k = 32
    cols, _ = chunk_case(k, cuda, seed=7)
    dbg, nid, _ = graph_case(cols, k, 1 << 20, seed=8)
    index = T.node_index(dbg.nodes, dbg.size, k)
    fw, _ = kmer_mod.extract_kmers(kmer_mod.unpack_bases(cols[0]), cols[1], k)
    canon, _ = kmer_mod.canonical(fw, k)
    got = T.lookup_plain(index, canon.reshape(-1, canon.shape[-1]))
    assert torch.equal(got, nid.reshape(-1))


def _reads(seed):
    genome = sim.random_genome(6000, seed=seed)
    # A tandem array makes junctions.
    genome = genome[:3000] + "ACGGT" * 40 + genome[3000:]
    return sim.simulate_reads(genome, coverage=20, read_len=500,
                              seed=seed + 1, sub_rate=0.01)


@pytest.mark.parametrize("membership", ["exact", "bloom_closure"])
def test_single_shot_through_kernel_equals_plain(cuda, membership,
                                                 monkeypatch):
    """A single-shot job on the card through the kernel, then through the
    plain chain: the same GFA and tallies, one launch through the kernel
    only.  Exact membership keeps stage 1's ids; the Bloom closure of a
    small filter renumbers the nodes, so stage 3 looks them up."""
    reads = _reads(51)
    kw = dict(k=25, chunk_len=256, log_path=None)
    if membership == "bloom_closure":
        kw.update(use_exact_membership=False, filter_bits=1 << 18,
                  num_hashes=2)
    cfg = AssemblyConfig(**kw)
    before = T.coverage_tally.kernel_launches
    fused = pipe.assemble(reads, cfg, write_output=False, device=cuda)
    assert T.coverage_tally.kernel_launches == before + 1
    if membership == "bloom_closure":
        assert fused.stats["closure_rounds"] >= 1
    monkeypatch.setattr(T, "uses_kernel", lambda packed, k: False)
    plain = pipe.assemble(reads, cfg, write_output=False, device=cuda)
    assert T.coverage_tally.kernel_launches == before + 1
    assert fused.gfa_lines == plain.gfa_lines and fused.num_straights >= 1
    assert fused.num_junctions >= 1
    assert torch.equal(fused.cov.node_cov, plain.cov.node_cov)
    assert torch.equal(fused.cov.jun_tally, plain.cov.jun_tally)


@pytest.mark.parametrize("k", [25, 32])
def test_streaming_through_kernel_equals_plain(cuda, k, monkeypatch):
    """One streaming job on the card through the kernel, then through the
    plain chain: the same GFA and tallies, and one launch a double-width
    slice through the kernel only."""
    reads = _reads(61)
    cfg = AssemblyConfig(k=k, chunk_len=256, log_path=None)
    chunks = reads_from_strings(reads, k, 256).num_chunks
    slices = -(-chunks // 16)
    before = T.coverage_tally.kernel_launches
    fused = assemble_streaming(reads, cfg, write_output=False,
                               slice_chunks=8, device=cuda)
    assert T.coverage_tally.kernel_launches == before + slices
    monkeypatch.setattr(T, "uses_kernel", lambda packed, k: False)
    plain = assemble_streaming(reads, cfg, write_output=False,
                               slice_chunks=8, device=cuda)
    assert T.coverage_tally.kernel_launches == before + slices
    assert fused.gfa_lines == plain.gfa_lines and fused.num_straights >= 1
    assert fused.stats["solid_nodes"] == plain.stats["solid_nodes"] > 0
    assert torch.equal(fused.cov.node_cov, plain.cov.node_cov)
    assert torch.equal(fused.cov.jun_tally, plain.cov.jun_tally)
