"""The port's blocked Bloom build and query against the JAX package.

On a CPU tensor ``ops/bloom_blocked.build_blocked_bloom`` runs its plain
PyTorch version; its words must be bit-equal to the Pallas kernel
``bloom_pallas.build_blocked_bloom`` run in interpret mode, with masked
and duplicate rows, and ``query_blocked`` must answer as the JAX query.
Where the Pallas build overflows its per-block budget the two differ on
purpose: the JAX words drop the rows past the budget, the port's keep
them.  The CUDA kernel is held to the plain version in
``tests/test_torch_cuda.py``, which needs the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platanus3_tpu.ops import bloom_pallas as JBP
from platanus3_tpu.ops import kmer as JK
from platanus3_tpu_torch import interop
from platanus3_tpu_torch.ops import bloom_blocked as TBB
from platanus3_tpu_torch.ops import hashing as TH

CASES = [(25, 19, 6), (25, 21, 8), (32, 21, 10)]


def _t(x):
    return interop.tensor_from_numpy(x)


def canon_batch(n, k, seed):
    """Canonical random k-mers ``[n, L]`` uint32, a quarter of the rows
    repeating other rows."""
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, 1 << 32, size=(n, JK.num_lanes(k)),
                         dtype=np.uint64).astype(np.uint32)
    lanes[:, 0] &= np.uint32(JK._top_mask(k))
    lanes[rng.integers(0, n, n // 4)] = lanes[rng.integers(0, n, n // 4)]
    return np.asarray(JK.canonical(jnp.asarray(lanes), k)[0])


@functools.lru_cache(maxsize=None)
def built(k, log2_bits, hashes):
    """(canon, mask, Pallas words as uint32, port words as uint32)."""
    canon = canon_batch(3000, k, seed=k * log2_bits + hashes)
    mask = np.random.default_rng(hashes).random(3000) < 0.8
    jw = JBP.build_blocked_bloom(jnp.asarray(canon), k, jnp.asarray(mask),
                                 log2_bits, hashes, interpret=True)
    tw = TBB.build_blocked_bloom(_t(canon), k, torch.from_numpy(mask),
                                 log2_bits, hashes)
    return canon, mask, np.asarray(jw), tw.numpy().view(np.uint32)


@pytest.mark.parametrize("k,log2_bits,hashes", CASES)
def test_words_bit_equal_to_pallas(k, log2_bits, hashes):
    _, _, jw, tw = built(k, log2_bits, hashes)
    assert tw.shape == ((1 << log2_bits) // 32,)
    assert np.array_equal(tw, jw)
    assert np.count_nonzero(tw) > 0


@pytest.mark.parametrize("k,log2_bits,hashes", CASES)
def test_query_equal_to_jax(k, log2_bits, hashes):
    canon, mask, jw, tw = built(k, log2_bits, hashes)
    words = interop.from_numpy_bloom(tw, log2_bits, hashes).bits
    probes = np.concatenate([canon, canon_batch(2000, k, seed=99)])
    want = np.asarray(JBP.query_blocked(jnp.asarray(jw), jnp.asarray(probes),
                                        k, log2_bits, hashes))
    got = TBB.query_blocked(words, _t(probes.reshape(1000, 5, -1)), k,
                            log2_bits, hashes).numpy()
    assert got.shape == (1000, 5)            # batch dims are kept
    assert np.array_equal(got.reshape(-1), want)
    assert got.reshape(-1)[:3000][mask].all()  # no false negatives


def test_all_masked_gives_zero_words():
    k = 32
    canon = canon_batch(64, k, seed=1)
    jw, jovf = JBP.build_blocked_bloom(
        jnp.asarray(canon), k, jnp.zeros(64, bool), log2_bits=19,
        num_hashes=6, interpret=True, return_overflow=True)
    tw, tovf = TBB.build_blocked_bloom(_t(canon), k,
                                       torch.zeros(64, dtype=torch.bool), 19,
                                       6, return_overflow=True)
    assert int(jovf) == 0 and int(tovf) == 0
    assert int(jnp.sum(jw)) == 0
    assert int(tw.abs().sum()) == 0


def test_no_mask_and_duplicates():
    """``mask=None`` keeps every row, and repeating rows changes nothing."""
    k = 25
    canon = canon_batch(500, k, seed=2)
    once = TBB.build_blocked_bloom(_t(canon), k, None, 20, 7)
    twice = TBB.build_blocked_bloom(_t(np.concatenate([canon, canon])), k,
                                    torch.ones(1000, dtype=torch.bool), 20, 7)
    assert torch.equal(once, twice)
    assert bool(TBB.query_blocked(once, _t(canon), k, 20, 7).all())


@pytest.mark.parametrize("log2_bits", [18, 36])
def test_log2_bits_out_of_range_raise(log2_bits):
    canon = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="log2_bits"):
        TBB.build_blocked_bloom(canon, 25, None, log2_bits, 4)
    with pytest.raises(ValueError, match="log2_bits"):
        TBB.query_blocked(torch.zeros(16, dtype=torch.int32), canon, 25,
                          log2_bits, 4)


def test_cpu_runs_plain_and_other_devices_raise():
    canon = torch.zeros((4, 2), dtype=torch.int64)
    before = TBB.build_blocked_bloom.kernel_launches
    TBB.build_blocked_bloom(canon, 25, None, 19, 4)
    assert TBB.build_blocked_bloom.kernel_launches == before  # CPU: plain
    with pytest.raises(ValueError, match="unsupported device"):
        TBB.build_blocked_bloom(canon.to("meta"), 25, None, 19, 4)
    with pytest.raises(TypeError):
        TBB.build_blocked_bloom(canon.to(torch.int32), 25, None, 19, 4)


def test_overflow_differs_from_jax_on_purpose():
    """7,000 distinct k-mers, all in block 0 of a 2^22-bit filter: the
    Pallas build's budget of ``c_max = 3`` chunks of 2048 rows drops 856
    of them, and its words miss exactly those; the port keeps every row
    and reports no overflow."""
    k, log2_bits, hashes, n = 25, 22, 6, 7000
    pool = np.unique(canon_batch(100_000, k, seed=7), axis=0)
    h1 = TH.hash_kmers(_t(pool), k, TH.SEED_H1).numpy()
    canon = pool[(h1 >> (32 - (log2_bits - 19))) == 0][:n]
    assert canon.shape[0] == n
    mask = np.ones(n, bool)
    jw, jovf = JBP.build_blocked_bloom(jnp.asarray(canon), k,
                                       jnp.asarray(mask), log2_bits, hashes,
                                       interpret=True, return_overflow=True)
    tw, tovf = TBB.build_blocked_bloom(_t(canon), k, torch.from_numpy(mask),
                                       log2_bits, hashes,
                                       return_overflow=True)
    assert int(jovf) == n - 3 * 2048 > 0
    assert int(tovf) == 0
    jw, tw = np.asarray(jw), tw.numpy().view(np.uint32)
    assert not np.any(jw & ~tw)          # JAX's bits are a subset
    assert np.any(jw != tw)
    jhit = np.asarray(JBP.query_blocked(jnp.asarray(jw), jnp.asarray(canon),
                                        k, log2_bits, hashes))
    assert int((~jhit).sum()) == int(jovf)
    words = interop.from_numpy_bloom(tw, log2_bits, hashes).bits
    assert bool(TBB.query_blocked(words, _t(canon), k, log2_bits,
                                  hashes).all())


@pytest.mark.parametrize("log2_bits", range(TBB.MIN_LOG2_BITS,
                                            TBB.MAX_LOG2_BITS + 1))
def test_blocked_layout(log2_bits):
    """Blocks split into at most 2^8 top buckets and sub-buckets; the
    sub-bucket rides above the item's 38 hash bits."""
    top_log2, sub_log2, blocks = TBB.blocked_layout(log2_bits)
    assert blocks << 19 == 1 << log2_bits
    assert top_log2 == min(log2_bits - 19, 8)
    assert 1 << (top_log2 + sub_log2) == blocks
    assert 38 + sub_log2 <= 64
    named = {19: (0, 0), 30: (8, 3), 33: (8, 6), 35: (8, 8)}
    if log2_bits in named:
        assert (top_log2, sub_log2) == named[log2_bits]
