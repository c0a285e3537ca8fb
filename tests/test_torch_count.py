"""The port's counting, window-min and solidity stage against the JAX
package: keys, counts, sizes, per-position values and padding rows are
all equal, at short_k 21 and k = 25 and 32."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from platanus3_tpu import pipeline as JP
from platanus3_tpu import sim as jsim
from platanus3_tpu.io import reads as jreads
from platanus3_tpu.ops import count as JC
from platanus3_tpu.ops import kmer as JK
from platanus3_tpu.ops import solid as JS
from platanus3_tpu.ops.windowmin import window_min as j_window_min
from platanus3_tpu_torch import interop
from platanus3_tpu_torch import pipeline as TP
from platanus3_tpu_torch.ops import count as TC
from platanus3_tpu_torch.ops import solid as TS
from platanus3_tpu_torch.ops.windowmin import window_min as t_window_min

CHUNK = 256


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return interop.tensor_from_numpy(x)


def assert_table_equal(jt, tt):
    assert int(jt.size) == int(tt.size)
    assert np.array_equal(_np(jt.keys), tt.keys.numpy())  # padding too
    assert np.array_equal(_np(jt.counts), tt.counts.numpy())


@pytest.fixture(scope="module")
def reads():
    g = jsim.random_genome(3000, seed=21)
    g = g[:1000] + g[200:400] + g[1000:]  # a repeat: counts above 1
    return jsim.simulate_reads(g, coverage=12, read_len=300, seed=22,
                               sub_rate=0.02)


def positions(reads, kk, k):
    """Canonical kk-mers of every chunk position + valid/owned masks, as
    the solidity stage builds them (numpy, from the JAX package)."""
    b = jreads.reads_from_strings(reads, k, CHUNK)
    bases = JK.unpack_bases(jnp.asarray(b.packed))
    canon, valid, owned = JS.short_kmer_positions(
        bases, jnp.asarray(b.valid_len), jnp.asarray(b.start),
        jnp.asarray(b.read_len), b.stride, kk, k)
    l = canon.shape[-1]
    return (np.asarray(canon).reshape(-1, l), np.asarray(valid).reshape(-1),
            np.asarray(owned).reshape(-1))


@pytest.mark.parametrize("kk,k", [(21, 25), (25, 25), (32, 32)])
def test_count_positions_table(reads, kk, k):
    canon, valid, owned = positions(reads, kk, k)
    jt, jpp = JC.count_positions_table(jnp.asarray(canon), jnp.asarray(valid),
                                       jnp.asarray(owned), k=kk)
    tt, tpp = TC.count_positions_table(_t(canon), _t(valid), _t(owned), k=kk)
    assert_table_equal(jt, tt)
    assert np.array_equal(_np(jpp), tpp.numpy())
    assert int(tt.size) < canon.shape[0]  # padding rows were compared


@pytest.mark.parametrize("kk,k", [(25, 25), (32, 32)])
def test_count_solid_with_ids(reads, kk, k):
    canon, valid, owned = positions(reads, kk, k)
    solid = owned & (np.random.default_rng(kk).random(owned.shape) < 0.7)
    for want_counts in (True, False):
        jt, jn = JC.count_solid_with_ids(
            jnp.asarray(canon), jnp.asarray(owned), jnp.asarray(solid), k=kk,
            want_counts=want_counts)
        tt, tn = TC.count_solid_with_ids(_t(canon), _t(owned), _t(solid),
                                         k=kk, want_counts=want_counts)
        assert_table_equal(jt, tt)
        assert np.array_equal(_np(jn), tn.numpy())


@pytest.mark.parametrize("k", [25, 32])
def test_count_kmers_merge_and_lookup(reads, k):
    canon, valid, owned = positions(reads, k, k)
    half = canon.shape[0] // 2
    ja = JC.count_kmers(jnp.asarray(canon[:half]), jnp.asarray(owned[:half]))
    jb = JC.count_kmers(jnp.asarray(canon[half:]), jnp.asarray(owned[half:]))
    ta = TC.count_kmers(_t(canon[:half]), _t(owned[:half]), k=k)
    tb = TC.count_kmers(_t(canon[half:]), _t(owned[half:]))
    assert_table_equal(ja, ta)
    assert_table_equal(jb, tb)
    jm, tm = JC.merge_tables(ja, jb), TC.merge_tables(ta, tb)
    assert_table_equal(jm, tm)
    # queries: present k-mers, absent ones and the extreme k-mers
    top = np.full((3, canon.shape[1]), 0xFFFFFFFF, np.uint32)
    top[:, 0] = JK._top_mask(k)
    q = np.concatenate([canon[::7], top,
                        np.zeros((2, canon.shape[1]), np.uint32)])
    want = _np(JC.lookup_id(jm, jnp.asarray(q)))
    assert np.array_equal(want, TC.lookup_id(tm, _t(q)).numpy())
    assert np.array_equal(_np(JC.lookup_id_join(jm, jnp.asarray(q), k=k)),
                          TC.lookup_id_join(tm, _t(q), k=k).numpy())


def test_k32_extreme_keys_sort_last_and_first():
    """k = 32 uses all 64 bits: the all-T k-mer must still sort after every
    other key and before the invalid rows."""
    k = 32
    rows = np.array([[0xFFFFFFFF, 0xFFFFFFFF], [0, 0], [0x80000000, 1],
                     [0x7FFFFFFF, 5], [0xFFFFFFFF, 0xFFFFFFFF], [3, 3]],
                    np.uint32)
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    jt = JC.count_kmers(jnp.asarray(rows), jnp.asarray(valid), k=k)
    tt = TC.count_kmers(_t(rows), _t(valid), k=k)
    assert_table_equal(jt, tt)
    assert int(tt.size) == 4 and int(tt.counts[3]) == 2


@pytest.mark.parametrize("w", [1, 3, 5, 12])
def test_window_min(w):
    v = np.random.default_rng(w).integers(0, 9, size=(4, 40)).astype(np.int32)
    assert np.array_equal(_np(j_window_min(jnp.asarray(v), w)),
                          t_window_min(_t(v), w).numpy())


@pytest.mark.parametrize("k", [25, 32])
def test_stage1_equal(reads, k):
    """``_stage1``: node table (with padding), seeds and per-position node
    ids are equal; so is the solidity stage underneath."""
    b = jreads.reads_from_strings(reads, k, CHUNK)
    jarr = [jnp.asarray(getattr(b, f)) for f in
            ("packed", "valid_len", "read_id", "start", "read_len")]
    tarr = [_t(getattr(b, f)) for f in
            ("packed", "valid_len", "read_id", "start", "read_len")]

    jres, _ = JS.solid_kmers(jarr, k, 21, 2, None, add_to_bloom=False)
    tres = TS.solid_kmers(tarr, k, 21, 2)
    for f in ("canon", "fw", "is_solid", "owned", "cov_est"):
        assert np.array_equal(_np(getattr(jres, f)),
                              _np(getattr(tres, f).numpy())), f
    assert_table_equal(jres.short_table, tres.short_table)

    jt, jseed, jhas, _, jnid = JP._stage1(
        *jarr, jnp.asarray(2, jnp.int32), k=k, short_k=21,
        num_reads=b.num_reads)
    tt, tseed, thas, tnid = TP._stage1(*tarr, 2, k=k, short_k=21,
                                       num_reads=b.num_reads)
    assert_table_equal(jt, tt)
    assert np.array_equal(_np(jseed), tseed.numpy())
    assert np.array_equal(np.asarray(jhas), thas.numpy())
    assert np.array_equal(_np(jnid), tnid.numpy())
    assert thas.any() and (tnid >= 0).any()


def test_owned_mask():
    start = np.array([0, 232, 0, 464], np.int32)
    rlen = np.array([500, 500, 30, 700], np.int32)
    for kk in (21, 25):
        j = JS.owned_mask(jnp.asarray(start), jnp.asarray(rlen), 232, 236,
                          kk, 25)
        t = TS.owned_mask(_t(start), _t(rlen), 232, 236, kk, 25)
        assert np.array_equal(np.asarray(j), t.numpy())


def test_multiword_k_not_ported():
    """Multi-word k is ported now: three lanes pack into two order words
    (lane 0 alone, then lanes 1-2) and unpack back."""
    lanes = torch.tensor([[1, 0xFFFFFFFF, 2], [0, 5, 0xFFFFFFFF]])
    words = TC.pack_keys(lanes)
    assert words.shape == (2, 2)
    assert torch.equal(TC.unpack_keys(words, 3), lanes)
    okey = TC.order_keys(lanes)
    assert bool(okey[1, 0] < okey[0, 0])
