"""The port's wide Bloom path (2^32 to 2^35 bits) and its multi-lane
inserts, with tolerance "exact" throughout.

From ``2^WIDE_LOG2_BITS`` bits on, the probes of a k-mer are
``(start + n*step) mod 2^log2_bits`` with ``start`` and ``step`` from a
64-bit hash of the whole k-mer (``hashing.wide_probe_pair``).  There the
port departs from the JAX package, whose wide probes come from the
murmur pair that gives some k-mers a twin (``ops/hashing.py``), so the
wide path is held to a plain reference written here with Python integers
(``_plain_positions``); below 2^32 bits the port still equals the JAX
package.  Lowering ``bloom.WIDE_LOG2_BITS`` drives the wide hash on a
small filter.  The CUDA kernel is held to the plain version at
2^32-2^35 bits in ``tests/test_torch_cuda.py``, which needs the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from platanus3_tpu.ops import bloom as JB
from platanus3_tpu.ops import kmer as JK
from platanus3_tpu_torch.ops import bloom as TB
from platanus3_tpu_torch.ops import hashing as TH

M64 = (1 << 64) - 1


def _fmix64(h):
    h ^= h >> 33
    h = h * 0xFF51AFD7ED558CCD & M64
    h ^= h >> 33
    h = h * 0xC4CEB9FE1A85EC53 & M64
    return h ^ (h >> 33)


def _plain_positions(lanes, k, hashes, log2_bits):
    """The wide probes of one k-mer's ``uint32`` lanes, from the
    definition: lanes paired into 64-bit words (an odd count puts lane 0
    alone first), each folded in by ``fmix64(h ^ word)`` from each seed,
    the seeds ``hash_init`` of SEED_H1 and SEED_H3, then of SEED_H2 and
    SEED_H4."""
    def init(seed):
        return (seed ^ (k * 0x9E3779B9)) & 0xFFFFFFFF

    lanes = [int(x) for x in lanes]
    words = lanes[:1] if len(lanes) % 2 else []
    words += [lanes[j] << 32 | lanes[j + 1]
              for j in range(len(lanes) % 2, len(lanes), 2)]
    out = []
    for a, b in ((TH.SEED_H1, TH.SEED_H3), (TH.SEED_H2, TH.SEED_H4)):
        h = init(a) << 32 | init(b)
        for w in words:
            h = _fmix64(h ^ w)
        out.append(h)
    mask = (1 << log2_bits) - 1
    start, step = out[0] & mask, (out[1] | 1) & mask
    return [(start + n * step) & mask for n in range(hashes)]


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def canon_batch(n, k, seed):
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, 1 << 32, size=(n, JK.num_lanes(k)),
                         dtype=np.uint64).astype(np.uint32)
    lanes[:, 0] &= np.uint32(JK._top_mask(k))
    lanes[rng.integers(0, n, n // 4)] = lanes[rng.integers(0, n, n // 4)]
    return np.asarray(JK.canonical(jnp.asarray(lanes), k)[0])


def words_u32(bf):
    return bf.bits.numpy().view(np.uint32)


@pytest.mark.parametrize("k,log2_bits,hashes,wide_from", [
    (25, 20, 6, 16), (32, 32, 10, 32), (48, 33, 10, 32), (64, 35, 4, 32),
    (101, 34, 7, 32)])
def test_probe_positions_wide(k, log2_bits, hashes, wide_from, monkeypatch):
    canon = canon_batch(2000, k, seed=k + log2_bits)
    want = np.array([_plain_positions(row, k, hashes, log2_bits)
                     for row in canon], dtype=np.int64).T
    got = TH.probe_positions(*TH.wide_probe_pair(_t(canon), k, log2_bits),
                             hashes, log2_bits)
    assert got.shape == (hashes, 2000)
    assert np.array_equal(got.numpy(), want)
    # A filter of that size takes them from WIDE_LOG2_BITS bits on.
    monkeypatch.setattr(TB, "WIDE_LOG2_BITS", wide_from)
    bf = TB.BloomFilter(None, log2_bits, hashes)
    assert np.array_equal(TB._probe_bits(bf, _t(canon), k).numpy(), want)


@pytest.mark.parametrize("k", [25, 48, 64])
def test_wide_add_and_query_match_jax(k, monkeypatch):
    """The wide hash on a 2^20-bit filter (WIDE_LOG2_BITS lowered to 16):
    words equal to those a plain build sets from ``_plain_positions``,
    queries to a plain lookup of the same bits."""
    monkeypatch.setattr(TB, "WIDE_LOG2_BITS", 16)
    canon = canon_batch(500, k, seed=k)
    mask = np.arange(500) < 400
    want = np.zeros((1 << 20) // 32, dtype=np.uint32)
    for row in canon[mask]:
        for p in _plain_positions(row, k, 6, 20):
            want[p >> 5] |= np.uint32(1 << (p & 31))
    tbf = TB.bloom_add_plain(TB.make_bloom(1 << 20, 6), _t(canon), k,
                             mask=torch.from_numpy(mask))
    assert np.array_equal(words_u32(tbf), want)
    # Re-adding the same k-mers changes nothing.
    again = TB.bloom_add_plain(tbf, _t(canon), k,
                               mask=torch.from_numpy(mask))
    assert torch.equal(again.bits, tbf.bits)

    probes = np.concatenate([canon, canon_batch(2000, k, seed=k + 1)])
    expect = np.array([all(want[p >> 5] >> np.uint32(p & 31) & 1
                           for p in _plain_positions(row, k, 6, 20))
                       for row in probes])
    got = TB.bloom_query(tbf, _t(probes), k).numpy()
    assert np.array_equal(got, expect)
    assert got[:400].all()                          # no false negative
    # The narrow path on the same filter places bits elsewhere.
    monkeypatch.setattr(TB, "WIDE_LOG2_BITS", 32)
    assert not torch.equal(
        TB.bloom_add_plain(TB.make_bloom(1 << 20, 6), _t(canon), k,
                           mask=torch.from_numpy(mask)).bits, tbf.bits)


@pytest.mark.parametrize("k", [48, 64, 128])
def test_bloom_add_multilane_matches_jax(k):
    """Every lane of a row is hashed: words and queries equal to the JAX
    ``bloom_add`` / ``bloom_query`` at three, four and eight lanes."""
    canon = canon_batch(3000, k, seed=3 * k)
    mask = np.random.default_rng(k).random(3000) < 0.8
    jbf = JB.bloom_add(JB.make_bloom(1 << 18, 7), jnp.asarray(canon), k,
                       mask=jnp.asarray(mask))
    tbf = TB.bloom_add(TB.make_bloom(1 << 18, 7), _t(canon), k,
                       mask=torch.from_numpy(mask))
    assert np.array_equal(words_u32(tbf), np.asarray(jbf.bits))
    want = np.asarray(JB.bloom_query(jbf, jnp.asarray(canon), k))
    assert np.array_equal(TB.bloom_query(tbf, _t(canon), k).numpy(), want)
    # A k-mer differing from an inserted one only in its last lane.
    other = canon[:1].copy()
    other[0, -1] ^= np.uint32(1)
    assert np.array_equal(
        TB.bloom_query(tbf, _t(other), k).numpy(),
        np.asarray(JB.bloom_query(jbf, jnp.asarray(other), k)))


def test_make_bloom_admits_2_35_bits():
    bf = TB.make_bloom(1 << 35, 4, device="meta")
    assert bf.log2_bits == 35 and bf.bits.shape == ((1 << 35) // 32,)
    assert TB.make_bloom((1 << 33) - 5, 4, device="meta").log2_bits == 33
    with pytest.raises(ValueError):
        TB.make_bloom((1 << 35) + 1, 4, device="meta")
