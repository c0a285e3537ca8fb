"""Large k in the port against the JAX package, on the inputs of
``tests/test_large_k.py`` (a clean genome of 3k + 1800 bases from the
same generator, tiled reads of 2k + 200 bases every (k + 100) / 4, a
2^22-bit filter): the GFA line for line, tolerance "exact".  k = 501 in
exact and in Bloom membership; k = 1001 and k = 3001, which cost minutes
of JAX CPU time, are marked ``slow``.
"""

import numpy as np
import pytest

from platanus3_tpu.config import AssemblyConfig as JConfig
from platanus3_tpu.pipeline import assemble as j_assemble
from platanus3_tpu_torch.config import AssemblyConfig as TConfig
from platanus3_tpu_torch.pipeline import assemble as t_assemble


def genome_of(k):
    """``tests/test_large_k.py`` draws its genomes for k = 501, 1001 and
    3001 in this order from one generator seeded 77."""
    rng = np.random.default_rng(77)
    for kk in (501, 1001, 3001):
        g = "".join(rng.choice(list("ACGT"), size=3 * kk + 1800))
        if kk == k:
            return g


def reads_of(k):
    g = genome_of(k)
    read_len, step = 2 * k + 200, (k + 100) // (4 if k < 3001 else 3)
    return [g[s:s + read_len] for s in range(0, len(g) - read_len + 1, step)]


def both(k, **kw):
    kw = dict(k=k, filter_bits=1 << 22, log_path=None, **kw)
    rs = reads_of(k)
    j = j_assemble(rs, JConfig(**kw), write_output=False)
    t = t_assemble(rs, TConfig(**kw), write_output=False, device="cpu")
    return j, t


@pytest.mark.parametrize("membership", ["exact", "bloom"])
def test_k501_gfa_identical(membership):
    j, t = both(501, use_exact_membership=membership == "exact")
    assert t.gfa_lines == j.gfa_lines
    assert (t.num_straights, t.num_junctions) == (1, 2)


@pytest.mark.slow
@pytest.mark.parametrize("k", [1001, 3001])
def test_huge_k_gfa_identical(k):
    j, t = both(k)
    assert t.gfa_lines == j.gfa_lines
    assert (t.num_straights, t.num_junctions) == (1, 2)
