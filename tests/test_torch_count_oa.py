"""The port's open-addressing k-mer counter against the JAX package.

On a CPU tensor ``ops/count_oa.count_kmers_oa`` runs its plain PyTorch
version; it is held here to the Pallas kernel
``count_pallas.count_kmers_oa`` run in interpret mode, and to the sort
counter, with no tolerance (integer arithmetic only).  Slot layout
depends on the order of inserts, so tables compare through
``oa_to_sorted``.  The CUDA kernel is held to the plain version in
``tests/test_torch_cuda.py``, which needs the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platanus3_tpu.ops import count_pallas as JOA
from platanus3_tpu.ops import kmer as JK
from platanus3_tpu_torch import interop, kernels
from platanus3_tpu_torch.ops import count as TC
from platanus3_tpu_torch.ops import count_oa as TOA
from platanus3_tpu_torch.ops import hashing as TH


def _t(x):
    return interop.tensor_from_numpy(x)


def random_lanes(rng, n, k):
    lanes = rng.integers(0, 1 << 32, size=(n, JK.num_lanes(k)),
                         dtype=np.uint64).astype(np.uint32)
    lanes[:, 0] &= np.uint32(JK._top_mask(k))
    return lanes


def canonical_np(lanes, k):
    return np.asarray(JK.canonical(jnp.asarray(lanes), k)[0])


def canon_rows(k, n, uniques, seed):
    """``n`` canonical rows drawn from ``uniques`` random k-mers."""
    rng = np.random.default_rng(seed)
    pool = random_lanes(rng, uniques, k)
    return canonical_np(pool[rng.integers(0, uniques, size=n)], k)


def run_jax(canon, contrib, k):
    table = JOA.count_kmers_oa(jnp.asarray(canon), jnp.asarray(contrib), k,
                               interpret=True)
    return table, JOA.oa_to_sorted(table)


def assert_sorted_equal(jsorted, tsorted):
    """Every row of the capacity: keys (padding too), counts and size."""
    assert int(jsorted.size) == int(tsorted.size)
    assert np.array_equal(np.asarray(jsorted.keys).astype(np.int64),
                          tsorted.keys.numpy())
    assert np.array_equal(np.asarray(jsorted.counts).astype(np.int64),
                          tsorted.counts.numpy())


def assert_equals_sort_counter(tsorted, canon, contrib, k):
    ref = TC.count_kmers(_t(canon), torch.from_numpy(contrib), k=k)
    n = int(ref.size)
    assert int(tsorted.size) == n
    assert torch.equal(tsorted.keys[:n], ref.keys[:n])
    assert torch.equal(tsorted.counts[:n], ref.counts[:n])


def check_against_jax(canon, contrib, k):
    """Port and Pallas tables agree in size, overflow and sorted content;
    returns the port's table."""
    jt, jsorted = run_jax(canon, contrib, k)
    tt = TOA.count_kmers_oa(_t(canon), torch.from_numpy(contrib), k)
    assert tuple(tt.keys.shape) == tuple(jt.keys.shape)
    assert tt.counts.dtype == torch.int32
    assert int(jt.overflow) == 0 and int(tt.overflow) == 0
    tsorted = TOA.oa_to_sorted(tt)
    assert_sorted_equal(jsorted, tsorted)
    assert_equals_sort_counter(tsorted, canon, contrib, k)
    assert TOA.probe_violations(tt, k) == 0
    return tt


@pytest.mark.parametrize("k", [11, 21, 25, 32])
def test_counts_match_pallas_and_sort_counter(k):
    canon = canon_rows(k, 500, 60, seed=k)
    contrib = np.random.default_rng(100 + k).random(500) < 0.8
    tt = check_against_jax(canon, contrib, k)
    assert int(TOA.oa_to_sorted(tt).size) > 40


@pytest.mark.parametrize("n,slots", [(500, 16384), (5000, 8192)])
def test_table_size_follows_the_jax_rule(n, slots):
    """The JAX sizing quirk: below 4096 rows ``(-1).bit_length()`` is 1,
    so 500 rows get two blocks and 5000 rows one."""
    k = 21
    canon = canon_rows(k, n, 50, seed=n)
    contrib = np.ones(n, bool)
    shape = jax.eval_shape(
        functools.partial(JOA.count_kmers_oa, k=k, interpret=True),
        jnp.asarray(canon), jnp.asarray(contrib))
    tt = TOA.count_kmers_oa(_t(canon), torch.from_numpy(contrib), k)
    assert tuple(tt.keys.shape) == tuple(shape.keys.shape) == (2, slots)
    assert tuple(tt.counts.shape) == tuple(shape.counts.shape)
    assert TOA.table_log2_blocks(10 ** 8) == 15   # 2^28 slots
    assert int(tt.counts.sum()) == n


def test_all_duplicates_single_slot():
    k = 25
    canon = canon_rows(k, 300, 1, seed=3)
    tt = check_against_jax(canon, np.ones(300, bool), k)
    occ = tt.counts > 0
    assert int(occ.sum()) == 1
    assert int(tt.counts[occ][0]) == 300
    # Moved two slots on, past empty slots, the key is unreachable.
    assert int(occ.nonzero()) % TOA.TB < TOA.TB - 2
    moved = tt._replace(keys=tt.keys.roll(2, dims=1),
                        counts=tt.counts.roll(2))
    assert TOA.probe_violations(moved, k) == 1


def test_no_contributing_row():
    k = 17
    canon = canon_rows(k, 8, 8, seed=4)
    tt = check_against_jax(canon, np.zeros(8, bool), k)
    assert int(tt.counts.abs().sum()) == 0
    assert int(TOA.oa_to_sorted(tt).size) == 0


def test_allones_lane_palindrome_k32():
    """T^16 A^16 is its own reverse complement with an all-ones lane 0;
    it is a real key, not the empty marker."""
    k = 32
    pal = JK.encode_kmers_np(["T" * 16 + "A" * 16])
    canon = np.concatenate([canonical_np(np.repeat(pal, 5, axis=0), k),
                            canon_rows(k, 40, 10, seed=5)])
    assert int(canon[0, 0]) == 0xFFFFFFFF
    contrib = np.ones(canon.shape[0], bool)
    tt = check_against_jax(canon, contrib, k)
    srt = TOA.oa_to_sorted(tt)
    row = int(srt.size) - 1          # the largest key sorts last
    assert srt.keys[row].tolist() == [0xFFFFFFFF, 0]
    assert int(srt.counts[row]) == 5


def test_probe_chains_wrap_inside_block():
    """Keys whose home slots crowd the end of block 0 probe past slot 8191
    and wrap to the block's start: the tables still agree and every
    occupied slot is reachable from its home."""
    k = 21
    rng = np.random.default_rng(6)
    pool = canonical_np(random_lanes(rng, 200_000, k), k)
    h1 = TH.hash_kmers(_t(pool), k, TH.SEED_H1).numpy()
    home = h1 & (TOA.TB - 1)
    crowd = pool[((h1 >> 31) == 0) & ((home >= TOA.TB - 6) | (home < 4))]
    assert crowd.shape[0] >= 30
    canon = crowd[rng.integers(0, crowd.shape[0], size=400)]
    contrib = rng.random(400) < 0.9
    tt = check_against_jax(canon, contrib, k)
    # some key sits past the wrap, far from the crowded homes
    assert bool((tt.counts[10:TOA.TB - 10] > 0).any())


def test_jax_table_through_interop():
    k = 25
    canon = canon_rows(k, 500, 60, seed=7)
    contrib = np.random.default_rng(7).random(500) < 0.8
    jt, jsorted = run_jax(canon, contrib, k)
    tt = interop.from_numpy_oa_table(jt)
    assert tt.keys.dtype == torch.int64 and tt.counts.dtype == torch.int32
    assert int(tt.overflow) == 0
    assert_sorted_equal(jsorted, TOA.oa_to_sorted(tt))
    assert TOA.probe_violations(tt, k) == 0


def test_full_block_counts_overflow():
    """More distinct keys than a block holds: the rows that find no slot,
    and a row packing to the empty marker, are overflow, not dropped."""
    k = 32
    rng = np.random.default_rng(8)
    pool = canonical_np(random_lanes(rng, 20_000, k), k)
    h1 = TH.hash_kmers(_t(pool), k, TH.SEED_H1).numpy()
    block0 = np.unique(pool[(h1 >> 31) == 0], axis=0)[:TOA.TB + 7]
    canon = np.concatenate([block0, np.full((1, 2), 0xFFFFFFFF, np.uint32)])
    assert TOA.table_log2_blocks(canon.shape[0]) == 1
    tt = TOA.count_kmers_oa(_t(canon), torch.ones(canon.shape[0],
                                                  dtype=torch.bool), k)
    assert int(tt.overflow) == 7 + 1
    assert int((tt.counts[:TOA.TB] == 1).sum()) == TOA.TB
    assert int(tt.counts[TOA.TB:].sum()) == 0
    assert TOA.probe_violations(tt, k) == 0


def test_wide_k_and_bad_inputs_raise():
    # Three lanes (k = 40) count now; bad inputs still raise.
    wide = TOA.count_kmers_oa(torch.zeros((4, 3), dtype=torch.int64),
                              torch.ones(4, dtype=torch.bool), 40)
    assert wide.keys.shape[0] == 3 and int(wide.counts.sum()) == 4
    with pytest.raises(ValueError):
        TOA.count_kmers_oa(torch.zeros((4, 2), dtype=torch.int64),
                           torch.ones(3, dtype=torch.bool), 25)
    with pytest.raises(ValueError, match="unsupported device"):
        TOA.count_kmers_oa(torch.zeros((4, 2), dtype=torch.int64,
                                       device="meta"),
                           torch.ones(4, dtype=torch.bool, device="meta"), 25)
    before = TOA.count_kmers_oa.kernel_launches
    TOA.count_kmers_oa(torch.zeros((4, 2), dtype=torch.int64),
                       torch.ones(4, dtype=torch.bool), 25)
    assert TOA.count_kmers_oa.kernel_launches == before  # CPU: plain


@pytest.mark.parametrize("g,levels", [(0, (0, 0)), (1, (1, 0)), (8, (8, 0)),
                                      (15, (8, 7)), (17, (8, 9))])
def test_partition_levels(g, levels):
    """2^g blocks split into at most 256 top buckets and their sub-buckets;
    the main run's 10^8 rows give 256 top buckets of 128 blocks."""
    assert kernels.partition_levels(g) == levels
    top, sub = levels
    assert top <= kernels.MAX_TOP_LOG2 and top + sub == g
    assert kernels.partition_levels(TOA.table_log2_blocks(102_521_452)) \
        == (8, 7)


def test_partition_offsets_place_every_row_once():
    """The scan between count and scatter, on the kernel's row walk
    (``ctas`` CTAs, grid-stride): each CTA's range of each top bucket
    starts where the CTAs before it end, top buckets in order, so the
    scatter places every contributing row once and each top bucket's rows
    lie together."""
    k, ctas, threads = 21, 3, 4
    canon = torch.from_numpy(canon_rows(k, 500, 200, seed=9).astype(np.int64))
    contrib = torch.from_numpy(np.random.default_rng(9).random(500) < 0.7)
    g = TOA.table_log2_blocks(500)
    top_log2, sub_log2 = kernels.partition_levels(g)
    block = TH.hash_kmers(canon, k, TH.SEED_H1) >> (32 - g)
    top = block >> sub_log2
    cta = (torch.arange(500) // threads) % ctas
    hist = torch.zeros((ctas, 1 << top_log2), dtype=torch.int32)
    for i in contrib.nonzero().squeeze(1).tolist():
        hist[cta[i], top[i]] += 1
    offsets, top_start = kernels.partition_offsets(hist)
    assert offsets.dtype == top_start.dtype == torch.int64
    assert top_start.shape == ((1 << top_log2) + 1,)
    assert int(top_start[-1]) == int(contrib.sum())
    cursor = offsets.clone()
    part = torch.full((int(contrib.sum()),), -1, dtype=torch.int64)
    for i in contrib.nonzero().squeeze(1).tolist():
        part[cursor[cta[i], top[i]]] = i
        cursor[cta[i], top[i]] += 1
    assert sorted(part.tolist()) == contrib.nonzero().squeeze(1).tolist()
    for t in range(1 << top_log2):
        run = part[top_start[t]:top_start[t + 1]]
        assert bool((top[run] == t).all())
