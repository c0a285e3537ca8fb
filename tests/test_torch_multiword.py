"""Multi-word k (k > 32) in the port against the JAX package, with
tolerance "exact" throughout.

k = 33, 48, 63, 64 and 101 cover three to seven lanes, odd and even lane
counts, and a top word with a spare bit (33, 48, 63, 101) or without one
(64).  Held equal: the counting core's tables (padding rows too), counts,
sizes and per-position node ids; node-id lookups; table merges; the
open-addressing counter's plain version against the Pallas kernel in
interpret mode; and single-shot assembly, GFA line for line.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from platanus3_tpu import sim as jsim
from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.io import reads as jreads
from platanus3_tpu.ops import count as JC
from platanus3_tpu.ops import count_pallas as JOA
from platanus3_tpu.ops import kmer as JK
from platanus3_tpu.ops import solid as JS
from platanus3_tpu.pipeline import assemble as j_assemble
from platanus3_tpu_torch import interop
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.ops import count as TC
from platanus3_tpu_torch.ops import count_oa as TOA
from platanus3_tpu_torch.pipeline import assemble as t_assemble

KS = [33, 48, 63, 64, 101]
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
    g = jsim.random_genome(2000, seed=61)
    g = g[:700] + g[100:350] + g[700:]    # a repeat: counts above 1
    return jsim.simulate_reads(g, coverage=8, read_len=400, seed=62,
                               sub_rate=0.02)


def positions(reads, k):
    """Canonical k-mers of every chunk position with the valid and owned
    masks, as stage 1 builds them (numpy, from the JAX package)."""
    b = jreads.reads_from_strings(reads, k, CHUNK)
    bases = JK.unpack_bases(jnp.asarray(b.packed))
    canon, valid, owned = JS.short_kmer_positions(
        bases, jnp.asarray(b.valid_len), jnp.asarray(b.start),
        jnp.asarray(b.read_len), b.stride, k, k)
    l = canon.shape[-1]
    return (np.asarray(canon).reshape(-1, l), np.asarray(valid).reshape(-1),
            np.asarray(owned).reshape(-1))


@pytest.mark.parametrize("k", KS)
def test_count_kmers(reads, k):
    canon, valid, _ = positions(reads, k)
    jt = JC.count_kmers(jnp.asarray(canon), jnp.asarray(valid), k=k)
    tt = TC.count_kmers(_t(canon), torch.from_numpy(valid), k=k)
    assert_table_equal(jt, tt)
    assert int(tt.counts.max()) > 1
    # Without k (no spare-bit fold) the table is the same.
    assert_table_equal(jt, TC.count_kmers(_t(canon),
                                          torch.from_numpy(valid)))


@pytest.mark.parametrize("k", KS)
def test_count_solid_with_ids(reads, k):
    canon, valid, owned = positions(reads, k)
    solid = owned & (np.random.default_rng(k).random(owned.shape[0]) < 0.7)
    jt, jnid = JC.count_solid_with_ids(
        jnp.asarray(canon), jnp.asarray(owned), jnp.asarray(solid), k=k)
    tt, tnid = TC.count_solid_with_ids(
        _t(canon), torch.from_numpy(owned), torch.from_numpy(solid), k=k)
    assert_table_equal(jt, tt)
    assert np.array_equal(_np(jnid), tnid.numpy())
    assert (tnid >= 0).any() and (tnid < 0).any()


@pytest.mark.parametrize("k", KS)
def test_lookup_id(reads, k):
    canon, valid, _ = positions(reads, k)
    jt = JC.count_kmers(jnp.asarray(canon), jnp.asarray(valid), k=k)
    tt = TC.count_kmers(_t(canon), torch.from_numpy(valid), k=k)
    # Every position's k-mer (present) and the same k-mers with the last
    # lane changed (mostly absent).
    absent = canon.copy()
    absent[:, -1] ^= np.uint32(0x5)
    queries = np.concatenate([canon[valid], absent[valid]])
    want = _np(JC.lookup_id_join(jt, jnp.asarray(queries), k=k))
    got = TC.lookup_id_join(tt, _t(queries), k=k).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(TC.lookup_id(tt, _t(queries)).numpy(),
                          _np(JC.lookup_id(jt, jnp.asarray(queries))))
    n = int(valid.sum())
    assert (got[:n] >= 0).all() and (got[n:] < 0).any()


@pytest.mark.parametrize("k", KS)
def test_merge_tables(reads, k):
    canon, valid, _ = positions(reads, k)
    half = canon.shape[0] // 2
    ja = JC.count_kmers(jnp.asarray(canon[:half]), jnp.asarray(valid[:half]),
                        k=k)
    jb = JC.count_kmers(jnp.asarray(canon[half:]), jnp.asarray(valid[half:]),
                        k=k)
    ta = TC.count_kmers(_t(canon[:half]), torch.from_numpy(valid[:half]),
                        k=k)
    tb = TC.count_kmers(_t(canon[half:]), torch.from_numpy(valid[half:]),
                        k=k)
    assert_table_equal(JC.merge_tables(ja, jb), TC.merge_tables(ta, tb))


@pytest.mark.parametrize("k", [48, 64])
def test_oa_counter_matches_pallas(k):
    """The plain OA counter through ``oa_to_sorted`` against the Pallas
    kernel in interpret mode and the sort counter."""
    rng = np.random.default_rng(k)
    pool = rng.integers(0, 1 << 32, size=(70, JK.num_lanes(k)),
                        dtype=np.uint64).astype(np.uint32)
    pool[:, 0] &= np.uint32(JK._top_mask(k))
    canon = np.asarray(JK.canonical(
        jnp.asarray(pool[rng.integers(0, 70, size=600)]), k)[0])
    contrib = rng.random(600) < 0.8
    jt = JOA.count_kmers_oa(jnp.asarray(canon), jnp.asarray(contrib), k,
                            interpret=True)
    tt = TOA.count_kmers_oa(_t(canon), torch.from_numpy(contrib), k)
    assert tuple(tt.keys.shape) == tuple(jt.keys.shape)
    assert int(jt.overflow) == 0 and int(tt.overflow) == 0
    assert_table_equal(JOA.oa_to_sorted(jt), TOA.oa_to_sorted(tt))
    ref = TC.count_kmers(_t(canon), torch.from_numpy(contrib), k=k)
    got = TOA.oa_to_sorted(tt)
    n = int(ref.size)
    assert int(got.size) == n
    assert torch.equal(got.keys[:n], ref.keys[:n])
    assert torch.equal(got.counts[:n], ref.counts[:n])
    assert TOA.probe_violations(tt, k) == 0


def test_oa_counter_empty_marker_is_overflow():
    """A row with every lane 0xFFFFFFFF (T^64, never canonical) is counted
    as overflow, never inserted."""
    k = 64
    rows = np.full((5, 4), 0xFFFFFFFF, np.uint32)
    rows[2:] = np.arange(12, dtype=np.uint32).reshape(3, 4)
    tt = TOA.count_kmers_oa(_t(rows), torch.ones(5, dtype=torch.bool), k)
    assert int(tt.overflow) == 2 and int(tt.counts.sum()) == 3


@pytest.mark.parametrize("k", [48, 64])
def test_assemble_gfa_identical(k):
    genome = jsim.random_genome(2500, seed=41)
    reads = jsim.simulate_reads(genome, coverage=25, read_len=250, seed=42,
                                sub_rate=0.01)
    kw = dict(k=k, chunk_len=512, log_path=None)
    j = j_assemble(reads, JConfig(**kw), write_output=False)
    t = t_assemble(reads, TConfig(**kw), write_output=False, device="cpu")
    assert t.gfa_lines == j.gfa_lines
    assert t.straight_seqs == j.straight_seqs
    assert t.num_straights >= 1
