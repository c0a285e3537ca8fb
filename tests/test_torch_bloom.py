"""The port's packed Bloom build and query against the JAX package.

The port's ``bloom_add`` (on the CPU: its plain PyTorch version) must give
words bit-equal to the JAX ``ops/bloom.bloom_add`` and to the Pallas
kernel ``bloom_pallas.build_packed_bloom`` run in interpret mode, with
masked and duplicate rows.  The CUDA kernel is held to the plain version
in ``tests/test_torch_cuda.py``, which needs the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from platanus3_tpu.ops import bloom as JB
from platanus3_tpu.ops import bloom_pallas as JBP
from platanus3_tpu.ops import kmer as JK
from platanus3_tpu_torch import interop, kernels
from platanus3_tpu_torch.ops import bloom as TB
from platanus3_tpu_torch.ops import hashing as TH


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def canon_batch(n, k, seed, dup_every=0):
    """Canonical random k-mers ``[n, L]`` uint32; with ``dup_every`` a
    share of the rows repeat earlier rows."""
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, 1 << 32, size=(n, JK.num_lanes(k)),
                         dtype=np.uint64).astype(np.uint32)
    lanes[:, 0] &= np.uint32(JK._top_mask(k))
    if dup_every:
        src = rng.integers(0, n, size=n // dup_every)
        dst = rng.integers(0, n, size=n // dup_every)
        lanes[dst] = lanes[src]
    canon, _ = JK.canonical(jnp.asarray(lanes), k)
    return np.asarray(canon)


def words_u32(bf):
    return bf.bits.numpy().view(np.uint32)


CASES = [(25, 16, 3), (25, 20, 10), (32, 16, 2), (32, 20, 7)]


@pytest.mark.parametrize("k,log2_bits,hashes", CASES)
def test_bloom_add_bit_equal(k, log2_bits, hashes):
    canon = canon_batch(3000, k, seed=log2_bits + k, dup_every=4)
    mask = np.random.default_rng(k).random(3000) < 0.8

    jbf = JB.bloom_add(JB.make_bloom(1 << log2_bits, hashes),
                       jnp.asarray(canon), k, mask=jnp.asarray(mask))
    pallas = JBP.build_packed_bloom(jnp.asarray(canon), k,
                                    jnp.asarray(mask), log2_bits, hashes,
                                    interpret=True)
    tbf = TB.bloom_add(TB.make_bloom(1 << log2_bits, hashes), _t(canon), k,
                       mask=torch.from_numpy(mask))
    assert tbf.log2_bits == jbf.log2_bits == log2_bits
    assert np.array_equal(words_u32(tbf), np.asarray(jbf.bits))
    assert np.array_equal(words_u32(tbf), np.asarray(pallas))

    # Unmasked insert into a non-empty filter ORs onto the old words.
    jbf2 = JB.bloom_add(jbf, jnp.asarray(canon[:500]), k)
    tbf2 = TB.bloom_add(tbf, _t(canon[:500]), k)
    assert np.array_equal(words_u32(tbf2), np.asarray(jbf2.bits))
    assert np.array_equal(words_u32(tbf), np.asarray(jbf.bits))  # unchanged


@pytest.mark.parametrize("k,log2_bits,hashes", CASES)
def test_bloom_query_equal(k, log2_bits, hashes):
    canon = canon_batch(3000, k, seed=7 * k + log2_bits)
    jbf = JB.bloom_add(JB.make_bloom(1 << log2_bits, hashes),
                       jnp.asarray(canon[:2000]), k)
    tbf = interop.from_numpy_bloom(np.asarray(jbf.bits), jbf.log2_bits,
                                   jbf.num_hashes)
    probes = canon.reshape(1000, 3, -1)   # batch dims are kept
    want = np.asarray(JB.bloom_query(jbf, jnp.asarray(probes), k))
    got = TB.bloom_query(tbf, _t(probes), k).numpy()
    assert got.shape == (1000, 3)
    assert np.array_equal(got, want)
    assert got.reshape(-1)[:2000].all()  # no false negatives


@pytest.mark.parametrize("log2_bits,region_words,regions,levels", [
    (5, 1, 1, (0, 0)), (10, 32, 1, (0, 0)), (19, 16384, 1, (0, 0)),
    (20, 16384, 2, (1, 0)), (30, 16384, 2048, (8, 3)),
    (31, 16384, 4096, (8, 4))])
def test_region_layout(log2_bits, region_words, regions, levels):
    """Regions of min(2^14, words) words tile the filter; every probe of a
    batch falls in one region, at an offset inside it."""
    assert TB.region_layout(log2_bits) == (region_words, regions)
    assert region_words * regions * 32 == 1 << log2_bits
    assert kernels.partition_levels(regions.bit_length() - 1) == levels
    canon = _t(canon_batch(2000, 25, seed=log2_bits))
    h1, h2 = TH.double_hash(canon, 25)
    pos = TH.probe_positions(h1, h2, 4, log2_bits)
    region_bits_log2 = region_words.bit_length() - 1 + 5
    assert int((pos >> region_bits_log2).max()) < regions
    assert int((pos & ((1 << region_bits_log2) - 1)).max()) \
        < region_words * 32


def test_bloom_add_checks_inputs():
    bf = TB.make_bloom(1 << 12, 2)
    good = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(TypeError):
        TB.bloom_add(bf, good.to(torch.int32), 25)
    with pytest.raises(ValueError):
        TB.bloom_add(bf, torch.zeros((4, 1), dtype=torch.int64), 25)
    with pytest.raises(ValueError):
        TB.bloom_add(bf, good, 25, mask=torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        TB.make_bloom(1 << 36, 2)
    before = TB.bloom_add.kernel_launches
    TB.bloom_add(bf, good, 25)
    assert TB.bloom_add.kernel_launches == before  # CPU: plain version
