"""The port's k-mer layer and hashing against the JAX package.

Inputs are made with numpy from a seed and go through both packages;
every comparison is exact (integer arithmetic).  Hashes must be
bit-equal: Bloom words, and through false positives the Bloom-mode
graph, depend on every bit.
"""

import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from platanus3_tpu import sim as jsim
from platanus3_tpu.io import reads as jreads
from platanus3_tpu.ops import hashing as JH
from platanus3_tpu.ops import kmer as JK
from platanus3_tpu_torch import sim as tsim
from platanus3_tpu_torch.io import reads as treads
from platanus3_tpu_torch.ops import hashing as TH
from platanus3_tpu_torch.ops import kmer as TK

KS = [21, 25, 32]


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def random_lanes(n, k, seed):
    """Random valid k-mers ``[n, L]`` uint32 (top lane masked to 2k bits)."""
    rng = np.random.default_rng(seed)
    lanes = rng.integers(0, 1 << 32, size=(n, JK.num_lanes(k)),
                         dtype=np.uint64).astype(np.uint32)
    lanes[:, 0] &= np.uint32(JK._top_mask(k))
    return lanes


@pytest.fixture(scope="module")
def batch_bases():
    rng = np.random.default_rng(5)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
            for n in (40, 300, 700, 1100)]
    return seqs


@pytest.mark.parametrize("k", KS)
def test_extract_and_canonical(k, batch_bases):
    jb = jreads.reads_from_strings(batch_bases, k, 256)
    tb = treads.reads_from_strings(batch_bases, k, 256)
    assert np.array_equal(jb.packed, tb.packed)
    jbases = JK.unpack_bases(jnp.asarray(jb.packed))
    tbases = TK.unpack_bases(_t(tb.packed))
    assert np.array_equal(_np(jbases), tbases.numpy())
    jfw, jvalid = JK.extract_kmers(jbases, jnp.asarray(jb.valid_len), k)
    tfw, tvalid = TK.extract_kmers(tbases, _t(tb.valid_len), k)
    assert np.array_equal(_np(jfw), tfw.numpy())
    assert np.array_equal(np.asarray(jvalid), tvalid.numpy())
    jc, jfwd = JK.canonical(jfw, k)
    tc, tfwd = TK.canonical(tfw, k)
    assert np.array_equal(_np(jc), tc.numpy())
    assert np.array_equal(np.asarray(jfwd), tfwd.numpy())


@pytest.mark.parametrize("k", KS)
def test_revcomp_shift_and_bases(k):
    lanes = random_lanes(2000, k, seed=k)
    j, t = jnp.asarray(lanes), _t(lanes)
    assert np.array_equal(_np(JK.revcomp(j, k)), TK.revcomp(t, k).numpy())
    assert np.array_equal(np.asarray(JK.is_palindrome(j, k)),
                          TK.is_palindrome(t, k).numpy())
    for b in range(4):
        assert np.array_equal(_np(JK.shift_in_right(j, np.uint32(b), k)),
                              TK.shift_in_right(t, b, k).numpy())
        assert np.array_equal(_np(JK.shift_in_left(j, np.uint32(b), k)),
                              TK.shift_in_left(t, b, k).numpy())
    assert np.array_equal(_np(JK.first_base(j, k)),
                          TK.first_base(t, k).numpy())
    assert np.array_equal(_np(JK.last_base(j, k)), TK.last_base(t, k).numpy())
    for pos in (0, k // 2, k - 1):
        assert np.array_equal(_np(JK.base_at(j, pos, k)),
                              TK.base_at(t, pos, k).numpy())
    assert TK.decode_kmers_np(t.numpy(), k) == JK.decode_kmers_np(lanes, k)


def test_palindromes_detected():
    k = 32
    rng = np.random.default_rng(9)
    half = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=16))
            for _ in range(50)]
    pals = [h + sim_revcomp(h) for h in half]
    enc = TK.encode_kmers_np(pals)
    assert TK.is_palindrome(_t(enc), k).all()
    assert np.array_equal(enc, JK.encode_kmers_np(pals))


def sim_revcomp(s):
    return tsim.revcomp(s)


@pytest.mark.parametrize("k", KS)
def test_hash_kmers_bit_equal(k):
    lanes = random_lanes(5000, k, seed=100 + k)
    # include the extremes of the lane range
    lanes[0] = 0
    lanes[1, 1:] = 0xFFFFFFFF
    lanes[1, 0] = JK._top_mask(k)
    j, t = jnp.asarray(lanes), _t(lanes)
    for seed in (0, 0x8C5FB1F7, 0xFFFFFFFF):
        assert np.array_equal(_np(JH.hash_kmers(j, k, seed)),
                              TH.hash_kmers(t, k, seed).numpy())
    jh1, jh2 = JH.double_hash(j, k)
    th1, th2 = TH.double_hash(t, k)
    assert np.array_equal(_np(jh1), th1.numpy())
    assert np.array_equal(_np(jh2), th2.numpy())
    for log2_bits in (12, 20, 31):
        assert np.array_equal(
            _np(JH.probe_positions(jh1, jh2, 7, log2_bits)),
            TH.probe_positions(th1, th2, 7, log2_bits).numpy())


def test_sim_same_seed_same_reads():
    jg = jsim.realistic_genome(60_000, seed=4, gc=0.508)
    tg = tsim.realistic_genome(60_000, seed=4, gc=0.508)
    assert jg == tg
    kw = dict(coverage=3, read_len=2000, seed=6, sub_rate=0.01,
              ins_rate=0.005, del_rate=0.005)
    assert jsim.simulate_reads(jg, **kw) == tsim.simulate_reads(tg, **kw)
    assert jsim.mutate_genome(jg, 20, seed=1, min_gap=100) == \
        tsim.mutate_genome(tg, 20, seed=1, min_gap=100)


def test_reads_file_loading_matches(tmp_path):
    rng = np.random.default_rng(12)
    seqs = ["".join("ACGTN"[c] for c in rng.integers(0, 5, size=n))
            for n in (10, 30, 600, 2500)]
    path = tmp_path / "r.fasta"
    path.write_text("".join(f">r{i}\n{s[:50]}\n{s[50:]}\n"
                            for i, s in enumerate(seqs)))
    jb = jreads.load_reads(str(path), 25, 512, use_native=False)
    tb = treads.load_reads(str(path), 25, 512)
    for f in ("packed", "valid_len", "read_id", "start", "read_len",
              "prev_base", "next_base"):
        assert np.array_equal(getattr(jb, f), getattr(tb, f)), f
    assert (jb.all_bases, jb.num_reads) == (tb.all_bases, tb.num_reads)


def test_port_imports_no_jax():
    """Every port module imports in a fresh process without JAX or the
    JAX package being loaded."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import platanus3_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'platanus3_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'platanus3_tpu' or n.startswith('platanus3_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules"
        " if n.startswith('platanus3_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 20
