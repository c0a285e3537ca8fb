"""The threshold sweep (BASELINE config 2) in the port against the JAX
package, on the inputs of ``tests/test_sweep.py``: every row equal (the
counts exactly, and the ratios, which are computed from them the same
way), with the truth genome and with ``assemble_each``; and the sweep's
arrays (each unique k-mer's max window-min coverage, the truth table)
equal array for array.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platanus3_tpu import sim as jsim
from platanus3_tpu import sweep as j_sweep
from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.io import reads as j_reads
from platanus3_tpu.ops import count as j_count
from platanus3_tpu_torch import sim as tsim
from platanus3_tpu_torch import sweep as t_sweep
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.ops import count as t_count


def cfgs(k=25):
    kw = dict(k=k, chunk_len=256, log_path=None)
    return JConfig(**kw), TConfig(**kw)


def noisy(genome_seed, n, cov, read_len, seed, sub):
    g = jsim.random_genome(n, seed=genome_seed)
    return g, jsim.simulate_reads(g, coverage=cov, read_len=read_len,
                                  seed=seed, sub_rate=sub)


def test_sweep_rows_with_truth_identical():
    g, reads = noisy(10, 3000, 30, 300, 11, 0.01)
    jc, tc = cfgs()
    j = j_sweep.solid_threshold_sweep(reads, jc, range(1, 8), truth_genome=g)
    t = t_sweep.solid_threshold_sweep(reads, tc, range(1, 8), truth_genome=g,
                                      device="cpu")
    assert t == j
    n_solid = [r["n_solid"] for r in t]
    assert all(a >= b for a, b in zip(n_solid, n_solid[1:]))
    assert max(r["f1"] for r in t) > 0.95


def test_sweep_rows_with_assemble_each_identical():
    g, reads = noisy(20, 2000, 40, 250, 21, 0.005)
    jc, tc = cfgs()
    j = j_sweep.solid_threshold_sweep(reads, jc, [2, 4, 6], truth_genome=g,
                                      assemble_each=True)
    t = t_sweep.solid_threshold_sweep(reads, tc, [2, 4, 6], truth_genome=g,
                                      assemble_each=True, device="cpu")
    assert t == j
    best = max(t, key=lambda r: r["f1"])
    assert best["max_unitig"] > 0.9 * len(g)


@pytest.mark.parametrize("k", [25, 32, 40])
def test_sweep_arrays_identical(k):
    g, reads = noisy(10, 3000, 30, 300, 11, 0.01)
    b = j_reads.reads_from_strings(reads, k, 256)
    jkeys, jcov, jsize = j_sweep._kmer_max_cov(
        *(jnp.asarray(getattr(b, f)) for f in
          ("packed", "valid_len", "read_id", "start", "read_len")),
        k=k, short_k=21)
    tkeys, tcov, tsize = t_sweep._kmer_max_cov(
        *(torch.from_numpy(getattr(b, f).astype(np.int64)) for f in
          ("packed", "valid_len", "read_id", "start", "read_len")),
        k=k, short_k=21)
    n = int(jsize)
    assert tsize == n > 0
    assert np.array_equal(tkeys[:n].numpy(),
                          np.asarray(jkeys)[:n].astype(np.int64))
    assert np.array_equal(tcov.numpy(), np.asarray(jcov).astype(np.int64))

    jt = jsim.genome_kmer_table(g, k)
    tt = tsim.genome_kmer_table(g, k, device="cpu")
    m = int(jt.size)
    assert int(tt.size) == m
    assert np.array_equal(tt.keys[:m].numpy(),
                          np.asarray(jt.keys)[:m].astype(np.int64))
    assert np.array_equal(tt.counts[:m].numpy(),
                          np.asarray(jt.counts)[:m].astype(np.int64))
    j_in = np.asarray(j_count.lookup_join(jt, jkeys)) > 0
    t_in = (t_count.lookup_join(tt, tkeys) > 0).numpy()
    assert np.array_equal(t_in, j_in)


def test_sweep_defaults_to_the_card(monkeypatch):
    fn = t_sweep.solid_threshold_sweep
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(["ACGT" * 20], cfgs()[1], [2])
    assert t_sweep.n50([50, 30, 20]) == 50 and t_sweep.n50([]) == 0


def test_genome_kmer_table_defaults_to_the_card(monkeypatch):
    fn = tsim.genome_kmer_table
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn("ACGT" * 20, 25)
