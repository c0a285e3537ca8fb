"""The ``slice_kmers`` kernel against the plain chain, on the card.

Every mode of ``ops/slice_kmers`` (the histograms of both passes,
collect-short and collect-solid) runs through the kernel and through its
plain PyTorch version on the same slices, on the card, and every output
must be array-equal.  The slices hold a padding chunk (valid_len 0, as a
mesh rank's block is padded), a chunk shorter than k, reads' last chunks
(which own their tail in pass 1) and reads that straddle slices.  A small
streaming job then runs through the kernel and through the plain path and
must give the same GFA and ``solid_nodes``.

They skip where ``torch.cuda.is_available()`` is false.  This file imports
neither JAX nor the JAX package, so on a machine with a card and without
JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_slice_kmers_cuda.py
"""

import numpy as np
import pytest
import torch

from platanus3_tpu_torch import sim
from platanus3_tpu_torch.config import AssemblyConfig
from platanus3_tpu_torch.io.reads import reads_from_strings
from platanus3_tpu_torch.ops import slice_kmers as SK
from platanus3_tpu_torch.streaming import assemble_streaming

pytestmark = pytest.mark.cuda

CHUNK_LEN, SLICE, PARTS, THRESHOLD = 256, 8, 16, 2
FIELDS = ("packed", "valid_len", "start", "read_len")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def chunk_arrays(k):
    """The chunks of simulated reads (some shorter than a chunk, so every
    read ends in a last chunk with a tail), with a padding chunk and a
    chunk of k - 1 valid bases put in among them."""
    genome = sim.random_genome(4000, seed=31)
    reads = sim.simulate_reads(genome, coverage=6, read_len=300, seed=32,
                               sub_rate=0.01)
    b = reads_from_strings(reads, k, CHUNK_LEN)
    cols = {f: getattr(b, f).astype(np.int64) for f in FIELDS}
    at = 2 * SLICE + 3
    short = {f: cols[f][at:at + 1].copy() for f in FIELDS}
    short["valid_len"][:] = k - 1
    pad = {f: np.zeros_like(cols[f][:1]) for f in FIELDS}
    return {f: np.concatenate([cols[f][:SLICE + 2], pad[f],
                               cols[f][SLICE + 2:at], short[f],
                               cols[f][at:]]) for f in FIELDS}


def slices(cols, device):
    c = cols["packed"].shape[0]
    for lo in range(0, c, SLICE):
        hi = min(lo + SLICE, c)
        yield lo, [torch.from_numpy(cols[f][lo:hi]).to(device)
                   for f in FIELDS]


def random_counts(c, short_k, device):
    p_short = CHUNK_LEN - short_k + 1
    gen = np.random.default_rng(33)
    return torch.from_numpy(gen.integers(
        0, 2 * THRESHOLD + 1, -(-c // SLICE) * SLICE * p_short,
        dtype=np.int32)).to(device)


@pytest.mark.parametrize("short_k,k", [(21, 25), (21, 32), (15, 17)])
@pytest.mark.parametrize("solid", [False, True], ids=["short", "solid"])
@pytest.mark.parametrize("collect", [False, True],
                         ids=["histogram", "collect"])
def test_slice_kmers_matches_plain(cuda, short_k, k, solid, collect):
    cols = chunk_arrays(k)
    c = cols["packed"].shape[0]
    assert c > 2 * SLICE + 4
    assert (cols["valid_len"] == 0).any() and \
        (cols["valid_len"] == k - 1).any()
    p_short = CHUNK_LEN - short_k + 1
    counts = random_counts(c, short_k, cuda)
    before = SK.slice_kmers.kernel_launches
    rows = seeds = 0
    for n, (lo, arrays) in enumerate(slices(cols, cuda), start=1):
        if solid:
            kw = dict(k=k, short_k=short_k, cov_threshold=THRESHOLD,
                      parts=PARTS, collect=collect)
            got = SK.solid_slice(counts, *arrays, lo * p_short, **kw)
            want = SK.solid_slice_plain(counts, *arrays, lo * p_short, **kw)
        else:
            kw = dict(k=k, short_k=short_k, parts=PARTS, collect=collect)
            got = SK.short_slice(*arrays, lo * p_short, **kw)
            want = SK.short_slice_plain(*arrays, lo * p_short, **kw)
        assert SK.slice_kmers.kernel_launches == before + n
        if not collect:
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
        part = got[-1] if not collect else got[1 + (not solid)]
        rows += int((part < PARTS).sum()) if collect else int(got[0].sum())
        if solid and collect:
            seeds += int((got[2] < SK.NO_SEED).sum())
    assert rows > 0
    assert seeds > 0 or not (solid and collect)


@pytest.mark.parametrize("k", [25, 32])
def test_streaming_through_kernel_equals_plain(cuda, k, monkeypatch):
    """One streaming job on the card through the kernel, then through the
    plain chain: the same GFA and solid nodes, and one launch a slice
    pass (4 slice passes a slice) through the kernel only."""
    genome = sim.random_genome(6000, seed=41)
    reads = sim.simulate_reads(genome, coverage=20, read_len=500, seed=42,
                               sub_rate=0.01)
    cfg = AssemblyConfig(k=k, chunk_len=CHUNK_LEN, log_path=None)
    slices_n = -(-reads_from_strings(reads, k, CHUNK_LEN).num_chunks // 16)
    before = SK.slice_kmers.kernel_launches
    fused = assemble_streaming(reads, cfg, write_output=False,
                               slice_chunks=16, device=cuda)
    assert SK.slice_kmers.kernel_launches == before + 4 * slices_n
    monkeypatch.setattr(SK, "uses_kernel", lambda packed, k: False)
    plain = assemble_streaming(reads, cfg, write_output=False,
                               slice_chunks=16, device=cuda)
    assert SK.slice_kmers.kernel_launches == before + 4 * slices_n
    assert fused.gfa_lines == plain.gfa_lines and fused.num_straights >= 1
    assert fused.stats["solid_nodes"] == plain.stats["solid_nodes"] > 0
