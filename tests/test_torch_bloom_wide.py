"""The port's wide Bloom path (2^32 to 2^35 bits) and its multi-lane
inserts against the JAX package, with tolerance "exact" throughout.

From ``2^lo_bits`` bits on, a probe is the wide position ``hi *
2^lo_bits + lo`` (``hashing.probe_positions_wide``).  As
``tests/test_count_bloom.py`` does for the JAX package, ``lo_bits = 16``
drives that path on a 2^20-bit filter; the production value is 32.  The
CUDA kernel is held to the plain version at 2^32-2^35 bits in
``tests/test_torch_cuda.py``, which needs the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from platanus3_tpu.ops import bloom as JB
from platanus3_tpu.ops import hashing as JH
from platanus3_tpu.ops import kmer as JK
from platanus3_tpu_torch.ops import bloom as TB
from platanus3_tpu_torch.ops import hashing as TH


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


@pytest.mark.parametrize("k,log2_bits,hashes,lo_bits", [
    (25, 20, 6, 16), (32, 32, 10, 32), (48, 33, 10, 32), (64, 35, 4, 32),
    (101, 34, 7, 32)])
def test_probe_positions_wide(k, log2_bits, hashes, lo_bits):
    canon = canon_batch(2000, k, seed=k + log2_bits)
    jhi, jlo = JH.probe_positions_wide(jnp.asarray(canon), k, hashes,
                                       log2_bits, lo_bits)
    thi, tlo = TH.probe_positions_wide(_t(canon), k, hashes, log2_bits,
                                       lo_bits)
    assert thi.shape == tlo.shape == (hashes, 2000)
    assert np.array_equal(thi.numpy(), np.asarray(jhi).astype(np.int64))
    assert np.array_equal(tlo.numpy(), np.asarray(jlo).astype(np.int64))


@pytest.mark.parametrize("k", [25, 48, 64])
def test_wide_add_and_query_match_jax(k):
    """The (hi, lo) path at lo_bits = 16 on a 2^20-bit filter: words equal
    to JAX ``_bloom_add_wide``, queries to ``_bloom_query_wide``."""
    canon = canon_batch(500, k, seed=k)
    mask = np.arange(500) < 400
    jbf = JB._bloom_add_wide(
        JB.BloomFilter(jnp.zeros(((1 << 20) // 32,), jnp.uint32), 20, 6),
        jnp.asarray(canon), k, jnp.asarray(mask), lo_bits=16)
    tbf = TB.bloom_add_plain(TB.make_bloom(1 << 20, 6), _t(canon), k,
                             mask=torch.from_numpy(mask), lo_bits=16)
    assert np.array_equal(words_u32(tbf), np.asarray(jbf.bits))
    # Re-adding the same k-mers changes nothing.
    again = TB.bloom_add_plain(tbf, _t(canon), k,
                               mask=torch.from_numpy(mask), lo_bits=16)
    assert torch.equal(again.bits, tbf.bits)

    probes = np.concatenate([canon, canon_batch(2000, k, seed=k + 1)])
    want = np.asarray(JB._bloom_query_wide(jbf, jnp.asarray(probes), k,
                                           lo_bits=16))
    got = TB.bloom_query(tbf, _t(probes), k, lo_bits=16).numpy()
    assert np.array_equal(got, want)
    assert got[:400].all()                          # no false negative
    # The narrow path on the same filter places bits elsewhere.
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
