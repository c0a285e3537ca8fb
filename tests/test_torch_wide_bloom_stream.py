"""Streaming assembly in Bloom membership through the wide hash, held to
the plain reference (``asmbench/references/debruijn.py``) line for line,
and the fault it mends.

The chromosome-sized configuration (``asmbench/configs/chr21_stream.json``)
streams in a filter of 2^33 bits, which takes its probes from the 64-bit
wide hash (``hashing.wide_probe_pair``).  Lowering
``bloom.WIDE_LOG2_BITS`` drives that hash on the small filters here.  The
reference builds the exact graph: a filter whose false positives are an
ideal filter's adds no false neighbour at these fills, so the GFA must be
equal.

The fault: murmur seeded only through its start value gives some k-mers
a twin, another k-mer with the same ``(h1, h2)`` and so the same probes
(``ops/hashing.py``).  A node's neighbour whose twin is a node reads
present; streaming counts it in the node's degree and makes no node of
it, so the GFA gains a junction and a straight.  ``_twins`` finds such a
pair at k = 25 and the tests plant it.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from asmbench.references import debruijn
from asmbench.traffic import gen
from platanus3_tpu_torch import cli, pipeline
from platanus3_tpu_torch.graph import build
from platanus3_tpu_torch.ops import bloom, hashing, kmer, partitioned

K = 25
M32 = (1 << 32) - 1
C1, C2 = 0xCC9E2D51, 0x1B873593


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def _f(x):
    """A lane's murmur body before it meets the state (numpy uint64)."""
    return _rotl(x * C1 & M32, 15) * C2 & M32


def _f_inv(y):
    y = y * pow(C2, -1, 1 << 32) & M32
    return _rotl(y, 17) * pow(C1, -1, 1 << 32) & M32


def _state(seed, a):
    """Murmur's state after lane 0 (value ``a``) from ``seed``'s start."""
    x = hashing.hash_init(K, seed) ^ _f(a)
    return (_rotl(x, 13) * 5 + 0xE6546B64) & M32


def _lanes(a, b):
    return torch.tensor([[int(a), int(b)]], dtype=torch.int64)


def _twins(count=1, seed=0):
    """``count`` pairs of canonical 25-mers ``(x, y)``, ``[1, 2]`` lanes
    each, with one ``(h1, h2)``: first lanes ``a != a'`` whose two seeds'
    states differ alike, and ``y``'s last lane chosen so that both seeds'
    states meet ``x``'s."""
    a = np.arange(1 << 18, dtype=np.uint64)
    diff = _state(hashing.SEED_H1, a) ^ _state(hashing.SEED_H2, a)
    order = np.argsort(diff, kind="stable")
    same = np.flatnonzero(diff[order][1:] == diff[order][:-1])
    rng = np.random.default_rng(seed)
    out = []
    for i in rng.permutation(same):
        a0, a1 = np.uint64(order[i]), np.uint64(order[i + 1])
        for b in rng.integers(0, 1 << 32, size=8, dtype=np.uint64):
            b1 = _f_inv(_f(b) ^ _state(hashing.SEED_H1, a0)
                        ^ _state(hashing.SEED_H1, a1))
            x, y = _lanes(a0, b), _lanes(a1, b1)
            if all(torch.equal(kmer.canonical(z, K)[0], z) for z in (x, y)):
                out.append((x, y))
                break
        if len(out) == count:
            return out
    raise AssertionError("no twins found")


def _string(lanes):
    return kmer.decode_kmers_np(lanes.numpy().astype(np.uint32), K)[0]


def test_murmur_pair_gives_twins_the_wide_hash_parts():
    (x, y), = _twins()
    assert not torch.equal(x, y)
    hx, hy = hashing.double_hash(x, K), hashing.double_hash(y, K)
    assert all(torch.equal(p, q) for p, q in zip(hx, hy))
    # The narrow probes are one; the wide ones are not.
    narrow = bloom.BloomFilter(None, 30, 10)
    assert torch.equal(bloom._probe_bits(narrow, x, K),
                       bloom._probe_bits(narrow, y, K))
    wx, wy = (hashing.probe_positions(*hashing.wide_probe_pair(z, K, 33),
                                      10, 33) for z in (x, y))
    assert not (wx == wy).any()


def test_wide_filter_holds_no_twin(monkeypatch):
    """The diagnosed cause at a small size: a filter holding one k-mer of
    each of 20 twin pairs answers for the other k-mer.  Through the wide
    hash (from 2^20 bits on here) it answers no."""
    monkeypatch.setattr(bloom, "WIDE_LOG2_BITS", 20)
    pairs = _twins(20, seed=1)
    xs = torch.cat([x for x, _ in pairs])
    ys = torch.cat([y for _, y in pairs])
    bf = bloom.bloom_add(bloom.make_bloom(1 << 20, 10), ys, K)
    assert bloom.bloom_query(bf, ys, K).all()
    assert not bloom.bloom_query(bf, xs, K).any()


# The seeds of the high probe bits of the JAX package's wide scheme
# (``platanus3_tpu/ops/hashing.probe_positions_wide``), which the port ran
# from 2^32 bits on before the wide hash.
_OLD_WIDE_SEEDS = (0x94D049BB, 0xBF58476D)


def _old_wide_probes(z, log2_bits=33, num_hashes=10):
    """``[num_hashes, rows]`` positions of the old wide scheme: the low 32
    bits ``h1 + n h2``, the high ``log2_bits - 32`` bits ``h3 + n h4``."""
    h1, h2 = hashing.double_hash(z, K)
    h3, h4 = (hashing.hash_kmers(z, K, seed=s) for s in _OLD_WIDE_SEEDS)
    n = torch.arange(num_hashes, dtype=torch.int64).unsqueeze(1)
    lo = (h1 + n * h2) & M32
    hi = (h3 + n * h4) & ((1 << (log2_bits - 32)) - 1)
    return hi << 32 | lo


def _old_wide_twins(count):
    """Twin pairs whose old wide probes at 2^33 bits are one set: their
    ``h3`` and ``h4`` agree in the one bit the high probes take."""
    pairs = [(x, y) for x, y in _twins(6 * count, seed=4)
             if torch.equal(_old_wide_probes(x), _old_wide_probes(y))]
    assert len(pairs) >= count
    return pairs[:count]


def test_old_wide_probes_are_the_jax_packages():
    from platanus3_tpu.ops import hashing as jax_hashing

    (x, y), = _old_wide_twins(1)
    z = torch.cat([x, y, _twins(1, seed=5)[0][0]])
    hi, lo = jax_hashing.probe_positions_wide(z.numpy().astype(np.uint32),
                                              K, 10, 33)
    want = np.asarray(hi).astype(np.int64) << 32 | np.asarray(lo)
    assert np.array_equal(_old_wide_probes(z).numpy(), want)
    assert np.array_equal(want[:, 0], want[:, 1])


@pytest.mark.cuda
def test_card_filter_of_2_33_bits_holds_no_old_wide_twin():
    """The fault at the cell's size on the card: 2^33 bits, 10 probes,
    the wide kernel.  A filter holding one k-mer of each of 8 pairs that
    the old wide scheme sent to one set of probes answers no for the
    other k-mer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    cuda = torch.device("cuda")
    pairs = _old_wide_twins(8)
    xs = torch.cat([x for x, _ in pairs]).to(cuda)
    ys = torch.cat([y for _, y in pairs]).to(cuda)
    before = bloom.bloom_add.kernel_launches
    bf = bloom.bloom_add(bloom.make_bloom(1 << 33, 10, device=cuda), ys, K)
    assert bloom.bloom_add.kernel_launches == before + 1
    assert bf.log2_bits == 33 >= bloom.WIDE_LOG2_BITS
    assert int(bloom.popcount(bf)) == 80
    assert bool(bloom.bloom_query(bf, ys, K).all())
    assert not bool(bloom.bloom_query(bf, xs, K).any())
    del bf
    torch.cuda.empty_cache()


def _write_reads(path, genome: str, read_len: int, step: int):
    codes = np.frombuffer(genome.encode(), np.uint8)
    codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), codes).astype(
        np.uint8)
    starts = list(range(0, len(genome) - read_len + 1, step))
    if starts[-1] != len(genome) - read_len:
        starts.append(len(genome) - read_len)
    reads = np.concatenate([codes[s:s + read_len] for s in starts])
    offs = np.arange(len(starts) + 1, dtype=np.int64) * read_len
    gen.write_fasta(path, reads, offs)
    return reads, offs


def _job(tmp_path, name, cli_args, profile):
    gfa, log = tmp_path / f"{name}.gfa", tmp_path / f"{name}.log"
    argv = ["-i", str(tmp_path / "reads.fasta"), *cli_args, "-o", str(gfa),
            "--log", str(log), "--device", "cpu"]
    assert cli.main(argv + (["--profile-stages"] if profile else [])) == 0
    stats = [ln for ln in log.read_text().splitlines() if "] stats {" in ln]
    return gfa.read_text(), json.loads(stats[-1].split("] stats ", 1)[1])


def _stream_args(log2_bits, slice_chunks, chunk_len):
    return ["--streaming", "-k", str(K), "--cov-threshold", "3",
            "--chunk-len", str(chunk_len), "--slice-chunks",
            str(slice_chunks), "--membership", "bloom", "-m",
            str(1 << log2_bits)]


def test_streaming_twin_neighbour_is_no_neighbour(tmp_path, monkeypatch):
    """A genome holding a node ``v`` and the twin ``y`` of ``v``'s absent
    right neighbour ``x``: streaming in a 2^22-bit filter (the wide hash)
    gives the reference's GFA, with no false neighbour."""
    monkeypatch.setattr(bloom, "WIDE_LOG2_BITS", 22)
    (x, y), = _twins(seed=2)
    xs, ys = _string(x), _string(y)
    rng = np.random.default_rng(3)
    genome = list("".join(rng.choice(list("ACGT"), size=30000)))
    genome[8000:8025] = "C" + xs[:-1]           # v, whose right neighbour
    genome[20000:20025] = ys                    # x is y's twin
    genome = "".join(genome)
    rc = xs[::-1].translate(str.maketrans("ACGT", "TGCA"))
    assert xs not in genome and rc not in genome
    reads, offs = _write_reads(tmp_path / "reads.fasta", genome, 2000, 200)
    gfa, stats = _job(tmp_path, "twin", _stream_args(22, 64, 4096),
                      profile=True)
    ref = debruijn.assemble(reads, offs, k=K, short_k=21, cov_threshold=3)
    assert stats["solid_nodes"] == ref.solid_nodes
    assert gfa == ref.gfa
    assert stats["counts"]["bloom_false_neighbours"] == 0


def test_streaming_bloom_matches_reference(tmp_path, monkeypatch):
    """A 200 kb genome with planted repeats, HiFi-like reads at 12x, five
    slices of 128 chunks of 4096 bases, in a 2^24-bit filter through the
    wide hash: the GFA equals the reference's line for line; the counters
    read no false neighbour and the filter's set bits, as many as an ideal
    filter's within 1 %.  Without ``--profile-stages`` they are not read."""
    monkeypatch.setattr(bloom, "WIDE_LOG2_BITS", 24)
    genome = gen.make_genome({"kind": "realistic", "length": 200000,
                              "gc": 0.41, "seed": 5}, gen.make_rng(5, 1))
    mix = {"coverage": 12, "read_len": 5000, "read_len_sd": 800,
           "min_read_len": 2000, "sub_rate": 0.0004, "ins_rate": 0.0008,
           "del_rate": 0.0008}
    reads, offs = gen.simulate_reads(genome, mix, gen.make_rng(7, 2),
                                     gen.make_rng(5, 3))
    gen.write_fasta(tmp_path / "reads.fasta", reads, offs)
    args = _stream_args(24, slice_chunks=128, chunk_len=4096)
    gfa, stats = _job(tmp_path, "traced", args, profile=True)
    ref = debruijn.assemble(reads, offs, k=K, short_k=21, cov_threshold=3)
    assert gfa == ref.gfa
    assert stats["solid_nodes"] == ref.solid_nodes
    counts = stats["counts"]
    assert counts["bloom_false_neighbours"] == 0
    m = 1 << 24
    ideal = m * (1 - np.exp(-10 * ref.solid_nodes / m))
    assert abs(counts["bloom_bits_set"] / ideal - 1) < 0.01
    assert stats["stages"]["pass2.bloom_insert"] > 0
    assert stats["stages"]["graph.bloom_query"] > 0
    _, plain = _job(tmp_path, "plain", args, profile=False)
    assert "bloom_false_neighbours" not in plain["counts"]
    assert "bloom_bits_set" not in plain["counts"]


def test_resume_redoes_the_passes_of_an_older_format(tmp_path,
                                                     monkeypatch):
    """A ``spass2`` checkpoint saved under the format before the wide
    hash holds a filter's words set by other probes; resuming from it
    would query them with the wide hash.  The run under the current
    format does not resume it: passes 1-2 run again, and the GFA is the
    reference's."""
    monkeypatch.setattr(bloom, "WIDE_LOG2_BITS", 22)
    genome = "".join(np.random.default_rng(19).choice(list("ACGT"),
                                                      size=20000))
    reads, offs = _write_reads(tmp_path / "reads.fasta", genome, 2000, 200)
    args = [*_stream_args(22, 4, 1024), "--checkpoint-dir",
            str(tmp_path / "ckpt")]
    assert pipeline.CHECKPOINT_FORMAT != "torch-fmt=1"
    with monkeypatch.context() as old:
        old.setattr(pipeline, "CHECKPOINT_FORMAT", "torch-fmt=1")
        first, _ = _job(tmp_path, "old", args, profile=False)
    assert any((d / "spass2.npz").is_file()
               for d in (tmp_path / "ckpt").iterdir())
    calls = []
    collect = partitioned.solid_collect_slice
    monkeypatch.setattr(partitioned, "solid_collect_slice",
                        lambda *a, **kw: calls.append(1) or collect(*a, **kw))
    gfa, _ = _job(tmp_path, "new", args, profile=False)
    assert calls
    ref = debruijn.assemble(reads, offs, k=K, short_k=21, cov_threshold=3)
    assert gfa == first == ref.gfa


def _chain_nodes(seq: str):
    enc = torch.from_numpy(kmer.encode_kmers_np(
        [seq[i:i + K] for i in range(len(seq) - K + 1)]).astype(np.int64))
    canon, _ = kmer.canonical(enc, K)
    keys = torch.unique(canon[:, 0] << 32 | canon[:, 1])
    return torch.stack([keys >> 32, keys & M32], dim=1)


def test_bloom_presence_comes_from_the_filter():
    """Stage 2 in Bloom membership reads each neighbour's presence from
    the filter alone: a neighbour the filter holds and the node table
    lacks is present (one false neighbour), and a node the filter lacks
    is no neighbour of the nodes beside it, though the table holds it."""
    rng = np.random.default_rng(11)
    seq = "".join(rng.choice(list("ACGT"), size=60))
    nodes = _chain_nodes(seq)
    size = torch.tensor(nodes.shape[0])
    table = bloom.bloom_add(bloom.make_bloom(1 << 20, 10), nodes, K)
    exact = build.build_graph(nodes, size, K, table, use_exact=False)
    assert int(build.false_neighbours(exact)) == 0
    # A k-mer beside the chain that is no node, in the filter only.
    extra = _chain_nodes(seq[10:34] + ("A" if seq[34] != "A" else "C"))
    more = bloom.bloom_add(table, extra, K)
    dbg = build.build_graph(nodes, size, K, more, use_exact=False)
    assert int(build.false_neighbours(dbg)) == 1
    assert int(dbg.right_present.sum() + dbg.left_present.sum()) == int(
        exact.right_present.sum() + exact.left_present.sum()) + 1
    # A node the filter lacks: its neighbours in the chain lose it.
    inner = _chain_nodes(seq[20:45])
    keep = ~(nodes == inner).all(dim=1)
    fewer = bloom.bloom_add(bloom.make_bloom(1 << 20, 10), nodes[keep], K)
    dbg = build.build_graph(nodes, size, K, fewer, use_exact=False)
    assert int(dbg.right_present.sum() + dbg.left_present.sum()) == int(
        exact.right_present.sum() + exact.left_present.sum()) - 2


def test_single_shot_counts_the_closures_first_round(tmp_path):
    """Single shot in a filter small enough for false neighbours: the
    counter reads as many as the first closure round adds as nodes."""
    rng = np.random.default_rng(13)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    _write_reads(tmp_path / "reads.fasta", genome, 600, 60)
    args = ["-k", str(K), "--membership", "bloom", "-m", str(1 << 16),
            "--chunk-len", "256"]
    _, stats = _job(tmp_path, "shot", args, profile=True)
    log = (tmp_path / "shot.log").read_text()
    first = [ln for ln in log.splitlines() if "bloom closure round 1:" in ln]
    assert first, "the filter gave no false neighbour"
    phantoms = int(first[0].split("round 1: ")[1].split()[0])
    assert stats["counts"]["bloom_false_neighbours"] == phantoms > 0
    assert stats["counts"]["bloom_bits_set"] > 0


def test_popcount_counts_every_bit():
    rng = np.random.default_rng(17)
    words = rng.integers(-2**31, 2**31, size=3 * (1 << 10), dtype=np.int64)
    bf = bloom.BloomFilter(torch.from_numpy(words.astype(np.int32)), 17, 1)
    want = int(np.unpackbits(words.astype(np.int32).view(np.uint8)).sum())
    assert int(bloom.popcount(bf)) == want
