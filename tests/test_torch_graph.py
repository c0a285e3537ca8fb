"""The port's graph stages against the JAX package, leaf by leaf.

The JAX stage-1 node table is fed into both packages' stage 2 (through
``interop``), so every ``DBG`` leaf, the phantom neighbours, coverage,
junction tallies, reach masks and member chars compare one to one.
Inputs: clean, branching (``mutate_genome``), circular with power-of-two
cycle lengths (32 and 64 nodes), and palindromic k-mers at even k; each
in exact and in Bloom membership, the Bloom filter small enough to give
false positives.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from platanus3_tpu import pipeline as JP
from platanus3_tpu import sim as jsim
from platanus3_tpu.graph import build as JG
from platanus3_tpu.io import reads as jreads
from platanus3_tpu.ops import bloom as JB
from platanus3_tpu_torch import interop
from platanus3_tpu_torch import pipeline as TP
from platanus3_tpu_torch.graph import build as TG
from platanus3_tpu_torch.ops import bloom as TB

CHUNK = 256
FIELDS = ("packed", "valid_len", "read_id", "start", "read_len")


def _np(x):
    return np.asarray(x).astype(np.int64)


def tiled(genome, read_len, step, circular=False):
    g = genome + genome[:read_len] if circular else genome
    last = len(genome) if circular else len(g) - read_len + 1
    return [g[s:s + read_len] for s in range(0, max(1, last), step)]


def _palindromic_genome():
    g = jsim.random_genome(700, seed=31)
    for at in (100, 350, 600):
        half = jsim.random_genome(16, seed=at)
        g = g[:at] + half + jsim.revcomp(half) + g[at + 32:]
    return g


def _inputs(name):
    """(reads, k) per input kind."""
    if name == "clean":
        return tiled(jsim.random_genome(1200, seed=1), 200, 40) * 2, 25
    if name == "branching":
        g = jsim.random_genome(1500, seed=2)
        h = jsim.mutate_genome(g, 6, seed=3, min_gap=120)
        return tiled(g, 200, 50) * 2 + tiled(h, 200, 50) * 2, 25
    if name in ("cycle32", "cycle64"):
        n = 32 if name == "cycle32" else 64
        return tiled(jsim.random_genome(n, seed=n), 40, 1, circular=True), 25
    if name == "palindromic":
        return tiled(_palindromic_genome(), 150, 25) * 2, 32
    raise KeyError(name)


INPUTS = ["clean", "branching", "cycle32", "cycle64", "palindromic"]
# (log2 bits, hashes) giving false-positive neighbours at these sizes
BLOOM = (12, 2)


@pytest.fixture(scope="module")
def stage1_cache():
    return {}


def jax_stage1(cache, name):
    if name not in cache:
        reads, k = _inputs(name)
        b = jreads.reads_from_strings(reads, k, CHUNK)
        arr = [jnp.asarray(getattr(b, f)) for f in FIELDS]
        table, seed_fw, has_seed, _, nid = JP._stage1(
            *arr, jnp.asarray(2, jnp.int32), k=k, short_k=21,
            num_reads=b.num_reads)
        n = int(table.size)
        nodes = JP._pad_table_keys(table.keys, n, JP._graph_cap(n))
        cache[name] = (b, k, nodes, n, seed_fw, has_seed, nid, table)
    return cache[name][:7]


def assert_dbg_equal(jd, td):
    for f in JG.DBG._fields:
        want, got = np.asarray(getattr(jd, f)), getattr(td, f).numpy()
        assert want.shape == got.shape, f
        assert np.array_equal(want.astype(got.dtype), got), f


@pytest.mark.parametrize("membership", ["exact", "bloom"])
@pytest.mark.parametrize("name", INPUTS)
def test_graph_stages_equal(stage1_cache, name, membership):
    b, k, nodes, n, seed_fw, has_seed, nid = jax_stage1(stage1_cache, name)
    use_exact = membership == "exact"
    size = jnp.asarray(n, jnp.int32)

    jbf = JB.make_bloom(1 << BLOOM[0], BLOOM[1])
    ttable = interop.from_numpy_table(stage1_cache[name][7])
    tnodes = TP.pad_table_keys(ttable.keys, n, TP.graph_cap(n))
    assert np.array_equal(_np(nodes), tnodes.numpy())
    tsize = ttable.size
    tbf = TB.make_bloom(1 << BLOOM[0], BLOOM[1])
    if not use_exact:
        jbf = JP._bloom_from_nodes(nodes, size, jbf, k=k)
        tbf = TP._bloom_from_nodes(tnodes, tsize, tbf, k=k)
        assert np.array_equal(tbf.bits.numpy().view(np.uint32),
                              np.asarray(jbf.bits))

    jd = JP.run_stage2(nodes, size, jbf, k=k, use_exact=use_exact)
    td = TP.run_stage2(tnodes, tsize, tbf, k=k, use_exact=use_exact)
    assert_dbg_equal(jd, td)
    assert int(td.num_unitigs) > 0 or name.startswith("cycle")

    jc, jm = JG.phantom_neighbors(jd, k)
    tc, tm = TG.phantom_neighbors(td, k)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert np.array_equal(_np(jc)[np.asarray(jm)], tc.numpy()[tm.numpy()])
    if use_exact:
        assert not tm.any()

    # Stage 3 with the stage-1 node ids and with ids looked up again; the
    # second run starts from the JAX package's graph.
    jarr = [jnp.asarray(getattr(b, f)) for f in FIELDS]
    tarr = [interop.tensor_from_numpy(getattr(b, f)) for f in FIELDS]
    jextra = [jnp.asarray(b.prev_base), jnp.asarray(b.next_base)]
    textra = [interop.tensor_from_numpy(b.prev_base),
              interop.tensor_from_numpy(b.next_base)]
    tseed = interop.tensor_from_numpy(seed_fw)
    thas = interop.tensor_from_numpy(has_seed)
    for has_nid in (True, False):
        jout = JP._stage3(jd, jarr[0], jarr[1], jarr[3], jarr[4], *jextra,
                          seed_fw, has_seed,
                          nid if has_nid else jnp.zeros((1, 1), jnp.int32),
                          k=k, has_nid=has_nid)
        tout = TP._stage3(td if has_nid else interop.from_numpy_dbg(jd),
                          tarr[0], tarr[1], tarr[3], tarr[4], *textra,
                          tseed, thas,
                          interop.tensor_from_numpy(nid) if has_nid
                          else None, k=k)
        jcov, jrj, jru, jch = jout
        tcov, trj, tru, tch = tout
        assert np.array_equal(_np(jcov.node_cov), tcov.node_cov.numpy())
        assert np.array_equal(_np(jcov.jun_tally), tcov.jun_tally.numpy())
        assert np.array_equal(np.asarray(jrj), trj.numpy())
        assert np.array_equal(np.asarray(jru), tru.numpy())
        assert np.array_equal(_np(jch), tch.numpy())


def test_palindromes_present():
    """The palindromic input really carries palindromic nodes."""
    from platanus3_tpu_torch.ops import kmer as TK
    cache = {}
    _, k, nodes, n, *_ = jax_stage1(cache, "palindromic")
    t = interop.tensor_from_numpy(nodes)[:n]
    assert int(TK.is_palindrome(t, k).sum()) >= 3
