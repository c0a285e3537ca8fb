"""``ops/partitioned`` in the port against the JAX package, function
against function, tolerance "exact".

Both packages' pass functions are driven slice by slice over the same
batch, as their ``assemble_streaming`` drives them: the pass-1 histograms
and capacity plan, the per-position counts array and the distinct short
k-mer count, the pass-2 histograms and plan, the rows of every partition of both
buffer sets, the seeds, the Bloom words and the node table.  k = 25 keys
are one order word, k = 33 keys two.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platanus3_tpu import sim as jsim
from platanus3_tpu.io import reads as j_reads
from platanus3_tpu.ops import bloom as j_bloom
from platanus3_tpu.ops import partitioned as jp
from platanus3_tpu_torch.ops import bloom as t_bloom
from platanus3_tpu_torch.ops import count as t_count
from platanus3_tpu_torch.ops import partitioned as tp

SHORT_K, CHUNK_LEN, SLICE, THRESHOLD, PARTS = 21, 256, 8, 2, 16
BLOOM_LOG2, HASHES = 16, 3


def batch(k):
    genome = jsim.random_genome(3000, seed=71)
    reads = jsim.simulate_reads(genome, coverage=12, read_len=400, seed=72,
                                sub_rate=0.01)
    return j_reads.reads_from_strings(reads, k, CHUNK_LEN)


def slices(b):
    for lo in range(0, b.num_chunks, SLICE):
        yield lo, min(lo + SLICE, b.num_chunks)


FIELDS = ("packed", "valid_len", "read_id", "start", "read_len")


def j_slice(b, lo, hi):
    pad = SLICE - (hi - lo)
    out = []
    for f in FIELDS:
        a = np.asarray(getattr(b, f)[lo:hi])
        if pad:
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        out.append(jnp.asarray(a))
    return out


def t_slice(b, lo, hi):
    return [torch.from_numpy(getattr(b, f)[lo:hi].astype(np.int64))
            for f in FIELDS]


def partition_rows(cols, bases, fills):
    """Each partition's rows ``[fills[p], columns]`` (uint32), sorted:
    rows may come in any order within a partition (the JAX package's
    sort is not stable)."""
    rows = np.stack([np.asarray(c).astype(np.uint32) for c in cols], axis=1)
    out = []
    for p in range(PARTS):
        r = rows[bases[p]:bases[p] + int(fills[p])]
        out.append(r[np.lexsort(r.T[::-1])])
    return out


def t_columns(bufs, lanes):
    """A torch buffer set as the JAX package's columns: the order keys'
    lanes, then the payload."""
    lanes_ = t_count.key_lanes(bufs[0], lanes).numpy()
    cols = [lanes_[:, j] for j in range(lanes)]
    return cols + [b.numpy().view(np.uint32) for b in bufs[1:]]


def run_jax(b, k):
    out = {}
    p_short = CHUNK_LEN - SHORT_K + 1
    total_s = -(-b.num_chunks // SLICE) * SLICE * p_short
    h_tot = h_max = jnp.zeros((PARTS,), jnp.int32)
    for lo, hi in slices(b):
        packed, vlen, _, start, rlen = j_slice(b, lo, hi)
        h_tot, h_max = jp.histogram_short_slice(
            h_tot, h_max, packed, vlen, start, rlen, k=k, short_k=SHORT_K,
            parts=PARTS)
    out["hist1"] = (np.asarray(h_tot), np.asarray(h_max))
    s_blks, caps, bases, rows = plan = jp.plan_caps(h_tot, h_max, PARTS)
    out["plan1"] = plan
    bufs = tuple(jnp.zeros((rows,), jnp.uint32) for _ in range(2 + 1))
    fills, ovf = jnp.zeros((PARTS,), jnp.int32), jnp.zeros((), bool)
    for lo, hi in slices(b):
        packed, vlen, _, start, rlen = j_slice(b, lo, hi)
        bufs, fills, ovf = jp.collect_short_slice(
            bufs, fills, ovf, packed, vlen, start, rlen,
            np.int32(lo * p_short), k=k, short_k=SHORT_K, parts=PARTS,
            s_blks=s_blks, caps=caps, bases=bases)
    out["bufs1"] = partition_rows(bufs, bases, np.asarray(fills))
    counts = jnp.zeros((total_s,), jnp.int32)
    n_short = 0
    for p in range(PARTS):
        counts, nu = jp.count_partition(counts, bufs, fills, np.int32(p),
                                        np.int32(bases[p]), short_k=SHORT_K,
                                        cap_p=caps[p])
        n_short += int(nu)
    out["counts"], out["n_short"] = np.asarray(counts), n_short
    h_tot = h_max = jnp.zeros((PARTS,), jnp.int32)
    for lo, hi in slices(b):
        packed, vlen, _, start, rlen = j_slice(b, lo, hi)
        h_tot, h_max = jp.histogram_solid_slice(
            h_tot, h_max, counts, packed, vlen, start, rlen,
            np.int32(lo * p_short), k=k, short_k=SHORT_K,
            cov_threshold=THRESHOLD, parts=PARTS)
    out["hist2"] = (np.asarray(h_tot), np.asarray(h_max))
    s_blks, caps, bases, rows = plan = jp.plan_caps(h_tot, h_max, PARTS)
    out["plan2"] = plan
    l_k = (k + 15) // 16
    bufs = tuple(jnp.zeros((rows,), jnp.uint32) for _ in range(l_k))
    fills, ovf = jnp.zeros((PARTS,), jnp.int32), jnp.zeros((), bool)
    min_pos = jnp.full((b.num_reads,), np.int32(2**30))
    seed_fw = jnp.zeros((b.num_reads, l_k), jnp.uint32)
    bf_bits = j_bloom.make_bloom(1 << BLOOM_LOG2, HASHES).bits
    for lo, hi in slices(b):
        packed, vlen, rid, start, rlen = j_slice(b, lo, hi)
        bufs, fills, ovf, min_pos, seed_fw, bf_bits = jp.solid_collect_slice(
            bufs, fills, ovf, min_pos, seed_fw, bf_bits, counts, packed,
            vlen, rid, start, rlen, np.int32(lo * p_short), k=k,
            short_k=SHORT_K, cov_threshold=THRESHOLD,
            num_reads=b.num_reads, parts=PARTS, s_blks=s_blks, caps=caps,
            bases=bases, add_bloom=True, bf_log2=BLOOM_LOG2,
            bf_hashes=HASHES)
    out["bufs2"] = partition_rows(bufs, bases, np.asarray(fills))
    out["min_pos"], out["seed_fw"] = np.asarray(min_pos), np.asarray(seed_fw)
    out["bloom"] = np.asarray(bf_bits)
    outs, n_ps = [], []
    for p in range(PARTS):
        o, n_p = jp.dedup_partition(bufs, fills, np.int32(p),
                                    np.int32(bases[p]), k=k, cap_p=caps[p])
        outs.append(o)
        n_ps.append(int(n_p))
    n_total = sum(n_ps)
    dst = tuple(jnp.full((n_total + max(caps),), np.uint32(0xFFFFFFFF))
                for _ in range(l_k))
    off = 0
    for o, n_p in zip(outs, n_ps):
        dst = jp.place_block(dst, o, np.int32(off))
        off += n_p
    table = jp.finalize_table(dst, np.int32(n_total), k=k)
    size = int(table.size)
    out["table"] = (np.asarray(table.keys)[:size], size)
    return out


def run_torch(b, k):
    out = {}
    p_short = CHUNK_LEN - SHORT_K + 1
    total_s = -(-b.num_chunks // SLICE) * SLICE * p_short
    zeros = lambda: torch.zeros((PARTS,), dtype=torch.int64)  # noqa: E731
    h_tot, h_max = zeros(), zeros()
    for lo, hi in slices(b):
        packed, vlen, _, start, rlen = t_slice(b, lo, hi)
        h_tot, h_max = tp.histogram_short_slice(
            h_tot, h_max, packed, vlen, start, rlen, k=k, short_k=SHORT_K,
            parts=PARTS)
    out["hist1"] = (h_tot.numpy(), h_max.numpy())
    s_blks, caps, bases, rows = plan = tp.plan_caps(h_tot.numpy(),
                                                    h_max.numpy(), PARTS)
    out["plan1"] = plan
    bufs = tp.make_buffers(rows, 1, True, "cpu")
    fills, ovf = zeros(), torch.zeros((), dtype=torch.bool)
    for lo, hi in slices(b):
        packed, vlen, _, start, rlen = t_slice(b, lo, hi)
        bufs, fills, ovf = tp.collect_short_slice(
            bufs, fills, ovf, packed, vlen, start, rlen, lo * p_short, k=k,
            short_k=SHORT_K, parts=PARTS, s_blks=s_blks, caps=caps,
            bases=bases)
    assert not bool(ovf)
    out["bufs1"] = partition_rows(t_columns(bufs, (SHORT_K + 15) // 16),
                                  bases, fills.numpy())
    counts = torch.zeros((total_s,), dtype=torch.int32)
    n_short = 0
    for p in range(PARTS):
        counts, nu = tp.count_partition(counts, bufs, fills, p, bases[p])
        n_short += nu
    out["counts"], out["n_short"] = counts.numpy(), n_short
    h_tot, h_max = zeros(), zeros()
    for lo, hi in slices(b):
        packed, vlen, _, start, rlen = t_slice(b, lo, hi)
        h_tot, h_max = tp.histogram_solid_slice(
            h_tot, h_max, counts, packed, vlen, start, rlen, lo * p_short,
            k=k, short_k=SHORT_K, cov_threshold=THRESHOLD, parts=PARTS)
    out["hist2"] = (h_tot.numpy(), h_max.numpy())
    s_blks, caps, bases, rows = plan = tp.plan_caps(h_tot.numpy(),
                                                    h_max.numpy(), PARTS)
    out["plan2"] = plan
    l_k = (k + 15) // 16
    bufs = tp.make_buffers(rows, (l_k + 1) // 2, False, "cpu")
    fills, ovf = zeros(), torch.zeros((), dtype=torch.bool)
    min_pos = torch.full((b.num_reads,), 2**30, dtype=torch.int64)
    seed_fw = torch.zeros((b.num_reads, l_k), dtype=torch.int64)
    bf = t_bloom.make_bloom(1 << BLOOM_LOG2, HASHES)
    for lo, hi in slices(b):
        packed, vlen, rid, start, rlen = t_slice(b, lo, hi)
        bufs, fills, ovf, min_pos, seed_fw, bf = tp.solid_collect_slice(
            bufs, fills, ovf, min_pos, seed_fw, bf, counts, packed, vlen,
            rid, start, rlen, lo * p_short, k=k, short_k=SHORT_K,
            cov_threshold=THRESHOLD, num_reads=b.num_reads, parts=PARTS,
            s_blks=s_blks, caps=caps, bases=bases, add_bloom=True)
    assert not bool(ovf)
    out["bufs2"] = partition_rows(t_columns(bufs, l_k), bases, fills.numpy())
    out["min_pos"], out["seed_fw"] = min_pos.numpy(), seed_fw.numpy()
    out["bloom"] = bf.bits.numpy().view(np.uint32)
    outs = [tp.dedup_partition(bufs, fills, p, bases[p], k=k)
            for p in range(PARTS)]
    n_total = sum(n for _, n in outs)
    dst = torch.full((n_total, l_k), 0xFFFFFFFF, dtype=torch.int64)
    off = 0
    for o, n_p in outs:
        dst = tp.place_block(dst, o, off)
        off += n_p
    table = tp.finalize_table(dst, n_total, k=k)
    size = int(table.size)
    out["table"] = (table.keys[:size].numpy(), size)
    return out


@functools.lru_cache(maxsize=None)
def runs(k):
    """Both packages' passes over one batch, once a k for this file."""
    b = batch(k)
    assert b.num_chunks > 2 * SLICE
    return run_jax(b, k), run_torch(b, k)


@pytest.mark.parametrize("k", [25, 33])
def test_partitioned_passes_identical(k):
    j, t = runs(k)
    for name in ("hist1", "hist2"):
        for a, w in zip(t[name], j[name]):
            assert np.array_equal(a, w.astype(np.int64)), name
    assert t["plan1"] == j["plan1"] and t["plan2"] == j["plan2"]
    assert int(j["hist2"][0].sum()) > 0
    assert np.array_equal(t["counts"], j["counts"])
    assert t["n_short"] == j["n_short"] > 0
    assert np.array_equal(t["min_pos"], j["min_pos"].astype(np.int64))
    assert np.array_equal(t["seed_fw"], j["seed_fw"].astype(np.int64))
    assert np.array_equal(t["bloom"], j["bloom"])
    assert t["table"][1] == j["table"][1] > 0
    assert np.array_equal(t["table"][0], j["table"][0].astype(np.int64))


@pytest.mark.parametrize("k", [25, 33])
@pytest.mark.parametrize("buffers", ["bufs1", "bufs2"])
def test_partitioned_buffers_identical(k, buffers):
    """Every partition of each buffer set holds the same rows (order keys'
    lanes, and pass 1's payloads) as the JAX package's."""
    j, t = runs(k)
    assert len(t[buffers]) == len(j[buffers]) == PARTS
    for p, (a, w) in enumerate(zip(t[buffers], j[buffers])):
        assert np.array_equal(a, w), (buffers, p)
    assert sum(len(a) for a in t[buffers]) > 0
