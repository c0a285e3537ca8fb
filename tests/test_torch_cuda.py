"""Tests that need a CUDA card: the port's kernels against their plain
PyTorch versions, GPU assemblies (single shot, multi-k, streaming) and
the threshold sweep against the CPU ones, and a mesh of four ranks on the
card against one device.

They skip where ``torch.cuda.is_available()`` is false.  This file imports
neither JAX nor the JAX package, so on a machine with a card and without
JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from platanus3_tpu_torch import sim
from platanus3_tpu_torch.config import AssemblyConfig
from platanus3_tpu_torch.graph.multik import assemble_multik
from platanus3_tpu_torch.io.reads import reads_from_strings
from platanus3_tpu_torch.ops import bloom as TB
from platanus3_tpu_torch.ops import bloom_blocked as TBB
from platanus3_tpu_torch.ops import count as TC
from platanus3_tpu_torch.ops import count_oa as TOA
from platanus3_tpu_torch.ops import hashing as TH
from platanus3_tpu_torch.ops import kmer as TK
from platanus3_tpu_torch.pipeline import assemble
from platanus3_tpu_torch.streaming import assemble_streaming
from platanus3_tpu_torch.sweep import solid_threshold_sweep

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def canon_batch(rows, k, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    lanes = torch.randint(0, 1 << 32, (rows, TK.num_lanes(k)),
                          generator=gen, device=device, dtype=torch.int64)
    lanes[:, 0] &= TK._top_mask(k)
    dup = torch.randint(0, rows, (2, rows // 3), generator=gen,
                        device=device)
    lanes[dup[0]] = lanes[dup[1]]
    return TK.canonical(lanes, k)[0]


@pytest.mark.parametrize("k,log2_bits,hashes",
                         [(25, 5, 3), (32, 10, 4), (25, 16, 3), (25, 20, 10),
                          (32, 16, 2), (32, 20, 7), (32, 30, 10),
                          (21, 31, 4),
                          # every lane hashed: three, four and eight lanes
                          (48, 20, 10), (64, 30, 10), (128, 24, 7),
                          # the wide positions, 2^32 to 2^35 bits
                          (32, 32, 10), (64, 33, 10), (48, 34, 3),
                          (25, 35, 4), (128, 35, 10)])
def test_bloom_set_bits_matches_plain(cuda, k, log2_bits, hashes):
    canon = canon_batch(200_000, k, seed=k + log2_bits, device=cuda)
    mask = torch.rand(200_000, device=cuda) < 0.9
    bf = TB.make_bloom(1 << log2_bits, hashes, device=cuda)
    before = TB.bloom_add.kernel_launches
    got = TB.bloom_add(bf, canon, k, mask=mask)
    torch.cuda.synchronize()
    assert TB.bloom_add.kernel_launches == before + 1
    want = TB.bloom_add_plain(bf, canon, k, mask=mask)
    assert torch.equal(got.bits, want.bits)
    assert torch.equal(bf.bits, torch.zeros_like(bf.bits))  # input intact
    # no mask, onto a non-empty filter
    got2 = TB.bloom_add(got, canon[:1000], k)
    assert torch.equal(got2.bits, TB.bloom_add_plain(want, canon[:1000],
                                                     k).bits)


@pytest.mark.parametrize("k,log2_bits", [(25, 20), (48, 24), (32, 30)])
def test_bloom_set_bits_wide_hash_on_a_small_filter(cuda, k, log2_bits,
                                                    monkeypatch):
    """The wide hash below 2^32 bits (``WIDE_LOG2_BITS`` lowered): the
    kernel's words equal the plain build's, and the card's queries the
    CPU's, every inserted k-mer present."""
    monkeypatch.setattr(TB, "WIDE_LOG2_BITS", 16)
    canon = canon_batch(200_000, k, seed=k + log2_bits, device=cuda)
    mask = torch.rand(200_000, device=cuda) < 0.9
    bf = TB.make_bloom(1 << log2_bits, 10, device=cuda)
    got = TB.bloom_add(bf, canon, k, mask=mask)
    want = TB.bloom_add_plain(bf, canon, k, mask=mask)
    assert torch.equal(got.bits, want.bits)
    on_card = TB.bloom_query(got, canon, k)
    assert bool(on_card[mask].all())
    on_cpu = TB.bloom_query(got._replace(bits=got.bits.cpu()), canon.cpu(),
                            k)
    assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.parametrize("k", [21, 32, 48, 64, 128])
def test_oa_count_insert_matches_plain(cuda, k):
    rows = 200_000
    lanes = TK.num_lanes(k)
    canon = canon_batch(rows, k, seed=k, device=cuda)
    if k % 32 == 0:  # the T^(k/2) A^(k/2) palindrome: top lanes all ones
        canon[:7] = torch.tensor([0xFFFFFFFF] * (lanes // 2)
                                 + [0] * (lanes // 2), device=cuda)
    contrib = torch.rand(rows, device=cuda) < 0.8
    contrib[:7] = True
    before = TOA.count_kmers_oa.kernel_launches
    got = TOA.count_kmers_oa(canon, contrib, k)
    torch.cuda.synchronize()
    assert TOA.count_kmers_oa.kernel_launches == before + 1
    want = TOA.count_kmers_oa_plain(canon, contrib, k)
    assert got.keys.shape == want.keys.shape == (lanes, 1 << 19)
    assert int(got.overflow) == 0 and int(want.overflow) == 0
    assert TOA.probe_violations(got, k) == 0
    g, w = TOA.oa_to_sorted(got), TOA.oa_to_sorted(want)
    for a, b in zip(g, w):
        assert torch.equal(a, b)
    ref = TC.count_kmers(canon, contrib, k=k)
    n = int(ref.size)
    assert int(g.size) == n
    assert torch.equal(g.keys[:n], ref.keys[:n])
    assert torch.equal(g.counts[:n], ref.counts[:n])


def assert_oa_equals_plain(got, canon, contrib, k):
    want = TOA.count_kmers_oa_plain(canon, contrib, k)
    assert int(got.overflow) == int(want.overflow)
    assert TOA.probe_violations(got, k) == 0
    for a, b in zip(TOA.oa_to_sorted(got), TOA.oa_to_sorted(want)):
        assert torch.equal(a, b)


def test_oa_full_block_counts_overflow(cuda):
    """8192 + 7 distinct keys of block 0 and one row packing to the empty
    marker: 8 rows of overflow, block 0 full, every chain intact."""
    k = 32
    pool = canon_batch(40_000, k, seed=8, device=cuda).unique(dim=0)
    h1 = TH.hash_kmers(pool, k, TH.SEED_H1)
    block0 = pool[(h1 >> 31) == 0][:TOA.TB + 7]
    assert block0.shape[0] == TOA.TB + 7
    canon = torch.cat([block0, torch.full((1, 2), 0xFFFFFFFF,
                                          dtype=torch.int64, device=cuda)])
    assert TOA.table_log2_blocks(canon.shape[0]) == 1
    contrib = torch.ones(canon.shape[0], dtype=torch.bool, device=cuda)
    got = TOA.count_kmers_oa(canon, contrib, k)
    assert int(got.overflow) == 7 + 1
    assert int((got.counts[:TOA.TB] == 1).sum()) == TOA.TB
    assert int(got.counts[TOA.TB:].sum()) == 0
    assert TOA.probe_violations(got, k) == 0


@pytest.mark.parametrize("k", [21, 32, 64])
def test_oa_skewed_key_count_exact(cuda, k):
    """One key 200,000 times among random rows: the warp merge of equal
    keys must still count every row."""
    rand = canon_batch(100_000, k, seed=40 + k, device=cuda)
    canon = torch.cat([rand, rand[:1].expand(200_000, -1)])
    gen = torch.Generator(device=cuda).manual_seed(k)
    canon = canon[torch.randperm(canon.shape[0], generator=gen,
                                 device=cuda)].contiguous()
    contrib = torch.ones(canon.shape[0], dtype=torch.bool, device=cuda)
    got = TOA.count_kmers_oa(canon, contrib, k)
    assert int(got.overflow) == 0
    want_rows = int((canon == rand[0]).all(dim=1).sum())
    assert want_rows >= 200_000
    at = ((got.keys.T == rand[0]).all(dim=1) & (got.counts > 0)).nonzero()
    assert at.numel() == 1 and int(got.counts[at[0, 0]]) == want_rows
    assert_oa_equals_plain(got, canon, contrib, k)


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("log2_bits", [19, 20, 30, 33, 35])
def test_bloom_blocked_set_bits_matches_plain(cuda, log2_bits, masked, k):
    hashes = 10
    canon = canon_batch(200_000, k, seed=log2_bits, device=cuda)
    mask = torch.rand(200_000, device=cuda) < 0.9 if masked else None
    before = TBB.build_blocked_bloom.kernel_launches
    got, ovf = TBB.build_blocked_bloom(canon, k, mask, log2_bits, hashes,
                                       return_overflow=True)
    torch.cuda.synchronize()
    assert TBB.build_blocked_bloom.kernel_launches == before + 1
    assert int(ovf) == 0
    want = TBB.build_blocked_bloom_plain(canon, k, mask, log2_bits, hashes)
    assert torch.equal(got, want)
    inserted = canon[mask] if masked else canon
    assert bool(TBB.query_blocked(got, inserted, k, log2_bits, hashes).all())


def kmers_in_block0(n, k, log2_bits, device):
    """At least ``n`` distinct canonical k-mers whose block in a
    ``2^log2_bits``-bit blocked filter is 0."""
    picked = torch.empty((0, TK.num_lanes(k)), dtype=torch.int64,
                         device=device)
    seed = 1000
    while picked.shape[0] < n:
        pool = canon_batch(1 << 25, k, seed=seed, device=device)
        h1 = TH.hash_kmers(pool, k, TH.SEED_H1)
        picked = torch.cat([picked, pool[(h1 >> (51 - log2_bits)) == 0]]
                           ).unique(dim=0)
        seed += 1
    return picked


@pytest.mark.parametrize("case", ["distinct", "copies"])
def test_bloom_blocked_skewed_block(cuda, case):
    """Every row in block 0 of a 2^30-bit filter: 200,000 distinct k-mers,
    or 200,000 copies of one.  Nothing caps a block's rows."""
    k, log2_bits, hashes = 32, 30, 10
    canon = kmers_in_block0(200_000, k, log2_bits, cuda)
    assert canon.shape[0] >= 200_000
    if case == "copies":
        canon = canon[:1].expand(200_000, -1).contiguous()
    before = TBB.build_blocked_bloom.kernel_launches
    got, ovf = TBB.build_blocked_bloom(canon, k, None, log2_bits, hashes,
                                       return_overflow=True)
    torch.cuda.synchronize()
    assert TBB.build_blocked_bloom.kernel_launches == before + 1
    assert int(ovf) == 0
    assert torch.equal(got, TBB.build_blocked_bloom_plain(
        canon, k, None, log2_bits, hashes))
    assert int(got[TBB.BLOCK_WORDS:].ne(0).sum()) == 0
    assert bool(TBB.query_blocked(got, canon, k, log2_bits, hashes).all())


def test_gpu_assembly_equals_cpu(cuda):
    genome = sim.random_genome(3000, seed=5)
    reads = sim.simulate_reads(genome, coverage=25, read_len=400, seed=6,
                               sub_rate=0.01)
    for kw in (dict(k=25), dict(k=32, use_exact_membership=False),
               dict(k=25, use_exact_membership=False, filter_bits=1 << 14,
                    num_hashes=2)):
        cfg = AssemblyConfig(chunk_len=512, log_path=None, **kw)
        gpu = assemble(reads, cfg, write_output=False, device=cuda)
        cpu = assemble(reads, cfg, write_output=False, device="cpu")
        assert gpu.gfa_lines == cpu.gfa_lines


def test_stage_timer_counts_a_planted_sync(cuda):
    """Under tracing one ``.item()`` in a span is one host sync of that
    span, the timer's barriers add none, and the sync debug mode is
    restored afterwards."""
    from platanus3_tpu_torch.utils.profiling import StageTimer
    x = torch.arange(1000, device=cuda)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with StageTimer(profile=True, device=cuda) as timer:
        assert torch.cuda.get_sync_debug_mode() == 1       # "warn"
        timer.begin("quiet")
        y = x * 2
        timer.begin("planted")
        with timer.part("planted.item"):
            assert (y + 1).sum().item() == 1000 * 999 + 1000
        timer.begin("after")
    assert torch.cuda.get_sync_debug_mode() == mode
    rise = {n: c["host_syncs"] for n, c in timer.span_counts.items()}
    assert rise == {"quiet": 0, "planted": 1, "planted.item": 1, "after": 0}
    assert timer.counts()["host_syncs"] == 1
    assert set(timer.peak_bytes) == {"quiet", "planted", "after"}


@pytest.mark.parametrize("entry", [assemble, assemble_streaming])
def test_gpu_trace_holds_a_range_for_every_span(cuda, tmp_path, entry):
    """A traced run on the card: a ``p3.<span>`` range for every span of
    its stats line, inside the traced window, parts inside their spans;
    host syncs counted in every span."""
    import json

    from platanus3_tpu_torch.utils.profiling import (RANGE_PREFIX,
                                                     TRACE_FILE,
                                                     TRACE_WINDOW)
    genome = sim.random_genome(3000, seed=5)
    reads = sim.simulate_reads(genome, coverage=25, read_len=400, seed=6,
                               sub_rate=0.01)
    cfg = AssemblyConfig(k=25, chunk_len=512, log_path=None,
                         trace_dir=str(tmp_path), profile_stages=True)
    stats = entry(reads, cfg, write_output=False, device=cuda).stats
    evs = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in evs
                if e.get("name") == name
                and e.get("cat") == "user_annotation"]

    (window,) = ranges(TRACE_WINDOW)
    span = None
    for name in stats["stages"]:
        (rng,) = ranges(RANGE_PREFIX + name)
        assert window[0] <= rng[0] <= rng[1] <= window[1]
        if "." in name:
            assert span[0] <= rng[0] <= rng[1] <= span[1]
        else:
            span = rng
    assert any(e.get("cat") == "kernel" for e in evs)
    assert stats["counts"]["host_syncs"] >= 1
    assert stats["counts"]["host_syncs"] == sum(
        c["host_syncs"] for n, c in stats["span_counts"].items()
        if "." not in n)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_gpu_multik_simplify_equals_cpu(cuda):
    """k = 32 then 64, tips and bubbles, Bloom membership in a 2^32-bit
    filter (the wide positions): the card's GFA equals the CPU's."""
    genome = sim.random_genome(3000, seed=9)
    reads = sim.simulate_reads(genome, coverage=25, read_len=400, seed=10,
                               sub_rate=0.01)
    cfg = AssemblyConfig(k=32, k_list=(32, 64), clip_tips=True,
                         pop_bubbles=True, use_exact_membership=False,
                         filter_bits=1 << 32, chunk_len=512, log_path=None)
    before = TB.bloom_add.kernel_launches
    gpu = assemble_multik(reads, cfg, write_output=False, device=cuda)
    assert TB.bloom_add.kernel_launches == before + 2
    cpu = assemble_multik(reads, cfg, write_output=False, device="cpu")
    assert gpu.gfa_lines == cpu.gfa_lines
    assert gpu.num_straights >= 1


def test_gpu_streaming_equals_cpu(cuda):
    """Streaming in Bloom membership, 16 chunks a slice, one
    ``bloom_set_bits`` launch a slice: the card's GFA equals the CPU's,
    and multi-k through streaming too."""
    genome = sim.random_genome(6000, seed=11)
    reads = sim.simulate_reads(genome, coverage=20, read_len=500, seed=12,
                               sub_rate=0.01)
    cfg = AssemblyConfig(k=25, use_exact_membership=False,
                         filter_bits=1 << 16, num_hashes=3, chunk_len=256,
                         log_path=None)
    slices = -(-reads_from_strings(reads, 25, 256).num_chunks // 16)
    before = TB.bloom_add.kernel_launches
    gpu = assemble_streaming(reads, cfg, write_output=False,
                             slice_chunks=16, device=cuda)
    assert TB.bloom_add.kernel_launches == before + slices
    cpu = assemble_streaming(reads, cfg, write_output=False,
                             slice_chunks=16, device="cpu")
    assert gpu.gfa_lines == cpu.gfa_lines and gpu.num_straights >= 1
    mk = AssemblyConfig(k=25, k_list=(25, 33), clip_tips=True,
                        chunk_len=256, log_path=None)
    assert assemble_multik(reads, mk, write_output=False, streaming=True,
                           slice_chunks=16, device=cuda).gfa_lines == \
        assemble_multik(reads, mk, write_output=False, streaming=True,
                        slice_chunks=16, device="cpu").gfa_lines


def test_gpu_sweep_equals_cpu(cuda):
    genome = sim.random_genome(3000, seed=10)
    reads = sim.simulate_reads(genome, coverage=30, read_len=300, seed=11,
                               sub_rate=0.01)
    cfg = AssemblyConfig(k=25, chunk_len=256, log_path=None)
    args = (reads, cfg, range(1, 8))
    assert solid_threshold_sweep(*args, truth_genome=genome, device=cuda) \
        == solid_threshold_sweep(*args, truth_genome=genome, device="cpu")


def test_gpu_mesh_of_four_ranks_equals_one_device(cuda, tmp_path):
    """Four ranks share the card (gloo): single shot in Bloom membership
    with the false-positive closure, and streaming in Bloom membership,
    each equal to the card's single-device GFA, with ``bloom_set_bits``
    launched on every rank."""
    import torch_mesh_worker as worker
    got = worker.launch(tmp_path, ["assemble_reference_filter",
                                   "stream_bloom"], device="cuda")
    reads, kw = worker.assemble_cases()["reference_filter"]
    one = assemble(reads, AssemblyConfig(log_path=None, **kw),
                   write_output=False, device=cuda)
    reads_s, kw_s, slice_chunks = worker.streaming_cases()["stream_bloom"]
    one_s = assemble_streaming(reads_s, AssemblyConfig(log_path=None, **kw_s),
                               write_output=False, slice_chunks=slice_chunks,
                               device=cuda)
    for name, want in (("assemble_reference_filter", one),
                       ("stream_bloom", one_s)):
        ranks = got[name]
        assert all(r["gfa"] == want.gfa_lines for r in ranks)
        per_rank = [r["bloom_set_bits_launches"]
                    for r in ranks[0]["stats"]["mesh"]["ranks"]]
        assert min(per_rank) >= 1, per_rank
        assert ranks[0]["stats"]["mesh"]["backend"] == (
            "nccl" if torch.cuda.device_count() >= 4 else "gloo")
